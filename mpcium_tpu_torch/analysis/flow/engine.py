"""Worklist taint propagator.

The engine runs a summary-based interprocedural analysis:

1. every function body is abstractly interpreted once, producing a
   :class:`Summary` — which params flow to the return value, whether the
   return is unconditionally tainted (the body called a *source*), and
   which *sink records* exist (a sink is either ``always`` hot, or
   conditional on a set of params being tainted);
2. a worklist iterates to fixpoint: when a callee's summary grows, its
   callers are re-interpreted, so taint crosses any number of call
   boundaries (store → protocol → node is three hops);
3. conditional sink records translate through call sites — the final
   finding carries the **full source→sink chain** of fids.

Taint values form a small lattice: ``deps`` (the current function's
params this value depends on — the symbolic half) plus ``tainted``
(definitely carries secret material — the concrete half, with an origin
description and the call chain it travelled). ``merge`` is pointwise
union; there is no widening because chains only grow along *new* call
edges and the call graph is finite.

What counts as source/sink/sanitizer is the policy's business
(:mod:`taint` builds the MPF7xx policy); the engine only knows the
lattice and the language.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..core import Finding
from .callgraph import CallGraph
from .symbols import FuncInfo, FuncNode, ProjectIndex, _dotted

EMPTY: frozenset = frozenset()


class TVal:
    """One abstract value."""

    __slots__ = ("deps", "tainted", "origin", "chain")

    def __init__(
        self,
        deps: frozenset = EMPTY,
        tainted: bool = False,
        origin: str = "",
        chain: Tuple[str, ...] = (),
    ):
        self.deps = deps
        self.tainted = tainted
        self.origin = origin
        self.chain = chain

    def merge(self, other: "TVal") -> "TVal":
        if other is CLEAN:
            return self
        if self is CLEAN:
            return other
        return TVal(
            self.deps | other.deps,
            self.tainted or other.tainted,
            self.origin or other.origin,
            self.chain or other.chain,
        )

    @property
    def hot(self) -> bool:
        return self.tainted or bool(self.deps)


CLEAN = TVal()


class SinkRec:
    """A sink inside some function: fires when ``always`` or when any
    param in ``param_deps`` receives tainted data from a caller."""

    __slots__ = (
        "kind", "detail", "line", "path", "symbol",
        "param_deps", "always", "origin", "chain",
    )

    def __init__(self, kind, detail, line, path, symbol,
                 param_deps, always, origin, chain):
        self.kind = kind
        self.detail = detail
        self.line = line
        self.path = path
        self.symbol = symbol
        self.param_deps = param_deps
        self.always = always
        self.origin = origin
        self.chain = chain  # fids from the sink's function down to the sink

    def ident(self):
        return (
            self.kind, self.detail, self.path, self.symbol,
            self.param_deps, self.always,
        )


class Summary:
    __slots__ = ("ret", "sinks")

    def __init__(self):
        self.ret = CLEAN
        self.sinks: List[SinkRec] = []


class Policy:
    """Source/sink/sanitizer decisions for one rule family."""

    rule_source = "MPF700"

    def source_call(self, fid: str) -> Optional[str]:
        """Origin label if calling ``fid`` yields secret material."""
        return None

    def source_name(self, name: str, fi: FuncInfo) -> Optional[str]:
        """Origin label if a bare name/attr is secret by naming."""
        return None

    def sanitizer(self, fid: Optional[str], dotted: str) -> bool:
        return False

    def sink(self, call: ast.Call, dotted: str, fi: FuncInfo,
             fid: Optional[str]) -> Optional[Tuple[str, str, str]]:
        """(rule, kind, detail) if ``call`` is a sink; the engine then
        checks which evaluated args are hot."""
        return None

    def raise_is_sink(self) -> Optional[Tuple[str, str]]:
        """(rule, kind) to treat tainted values in ``raise X(...)``
        arguments as a sink."""
        return None

    def cleaner_builtin(self, name: str) -> bool:
        return name in (
            "len", "type", "isinstance", "issubclass", "id", "hash",
            "range", "enumerate", "zip", "bool", "callable",
        )

    def public_attr(self, name: str) -> bool:
        """Attrs that stay clean even on a tainted base (``share.epoch``
        is public although ``share`` is secret material)."""
        return False


# container mutations that write argument taint into the receiver
_MUTATORS = {
    "append", "add", "extend", "update", "insert", "setdefault",
    "appendleft", "push",
}


class FlowEngine:
    def __init__(self, index: ProjectIndex, graph: CallGraph, policy: Policy):
        self.index = index
        self.graph = graph
        self.policy = policy
        self.summaries: Dict[str, Summary] = {}
        self.findings: Dict[str, Finding] = {}  # fingerprint -> finding

    # ------------------------------------------------------------------

    def run(self) -> List[Finding]:
        work: List[str] = list(self.index.functions)
        queued = set(work)
        rounds = 0
        while work:
            fid = work.pop()
            queued.discard(fid)
            rounds += 1
            if rounds > 20 * len(self.index.functions):  # safety valve
                break
            old = self.summaries.get(fid)
            new = self._interpret(fid)
            if old is None or self._grew(old, new):
                self.summaries[fid] = new
                for caller in self.graph.callers.get(fid, ()):
                    if caller not in queued:
                        queued.add(caller)
                        work.append(caller)
        return sorted(
            self.findings.values(),
            key=lambda f: (f.path, f.line, f.rule, f.key),
        )

    @staticmethod
    def _grew(old: Summary, new: Summary) -> bool:
        if (new.ret.deps - old.ret.deps) or (
            new.ret.tainted and not old.ret.tainted
        ):
            return True
        seen = {s.ident() for s in old.sinks}
        return any(s.ident() not in seen for s in new.sinks)

    # ------------------------------------------------------------------

    def _interpret(self, fid: str) -> Summary:
        fi = self.index.functions[fid]
        summ = Summary()
        env: Dict[str, TVal] = {}
        for p in fi.params:
            tv = TVal(deps=frozenset([p]))
            origin = None
            if p in fi.secret_params:
                origin = f"Secret[...] param '{p}'"
            else:
                origin = self.policy.source_name(p, fi)
            if origin:
                tv = TVal(frozenset([p]), True, origin, (fid,))
            env[p] = tv
        self._exec_block(fi.node.body, env, fi, summ)
        return summ

    # -- statements ----------------------------------------------------

    def _exec_block(self, stmts, env, fi: FuncInfo, summ: Summary) -> None:
        for st in stmts:
            self._exec(st, env, fi, summ)

    def _exec(self, st, env, fi: FuncInfo, summ: Summary) -> None:
        pf = fi.pf
        if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = getattr(st, "value", None)
            if value is None:
                return
            tv = self._eval(value, env, fi, summ)
            if st.lineno in pf.declassified:
                tv = CLEAN
            targets = (
                st.targets if isinstance(st, ast.Assign) else [st.target]
            )
            for t in targets:
                self._bind(t, tv, env, fi, summ, aug=isinstance(st, ast.AugAssign))
        elif isinstance(st, ast.Expr):
            self._eval(st.value, env, fi, summ)
        elif isinstance(st, ast.Return):
            if st.value is not None:
                tv = self._eval(st.value, env, fi, summ)
                if fi.secret_return and not tv.tainted:
                    tv = tv.merge(
                        TVal(EMPTY, True, f"Secret[...] return of {fi.qualname}",
                             (fi.fid,))
                    )
                summ.ret = summ.ret.merge(tv)
        elif isinstance(st, ast.Raise):
            self._exec_raise(st, env, fi, summ)
        elif isinstance(st, (ast.If, ast.While)):
            self._eval(st.test, env, fi, summ)
            self._exec_block(st.body, env, fi, summ)
            self._exec_block(st.orelse, env, fi, summ)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            tv = self._eval(st.iter, env, fi, summ)
            self._bind(st.target, tv, env, fi, summ)
            self._exec_block(st.body, env, fi, summ)
            self._exec_block(st.orelse, env, fi, summ)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                tv = self._eval(item.context_expr, env, fi, summ)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, tv, env, fi, summ)
            self._exec_block(st.body, env, fi, summ)
        elif isinstance(st, ast.Try):
            self._exec_block(st.body, env, fi, summ)
            for h in st.handlers:
                if h.name:
                    env[h.name] = CLEAN  # MPF702 fires at the raise site
                self._exec_block(h.body, env, fi, summ)
            self._exec_block(st.orelse, env, fi, summ)
            self._exec_block(st.finalbody, env, fi, summ)
        elif isinstance(st, FuncNode + (ast.ClassDef,)):
            return  # nested defs are analysed under their own fid
        elif isinstance(st, (ast.Assert,)):
            self._eval(st.test, env, fi, summ)
            if st.msg is not None:
                self._eval(st.msg, env, fi, summ)
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    env[t.id] = CLEAN
        elif isinstance(st, (ast.Match,)):
            self._eval(st.subject, env, fi, summ)
            for case in st.cases:
                self._exec_block(case.body, env, fi, summ)

    def _bind(self, target, tv: TVal, env, fi, summ, aug: bool = False) -> None:
        if isinstance(target, ast.Name):
            if aug:
                tv = tv.merge(env.get(target.id, CLEAN))
            env[target.id] = tv
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, tv, env, fi, summ)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tv, env, fi, summ)
        elif isinstance(target, ast.Attribute):
            base = _dotted(target)
            if base:  # self.x or obj.x — track as a scoped pseudo-name
                prev = env.get(base, CLEAN)
                env[base] = prev.merge(tv)
                # writing rep.x = secret makes the whole local object hot
                # (so `return rep` carries it); self stays exempt — methods
                # seed their own attr taint from source_name instead
                root = base.split(".", 1)[0]
                if base != root and root not in ("self", "cls"):
                    env[root] = env.get(root, CLEAN).merge(tv)
        elif isinstance(target, ast.Subscript):
            # dict/list round-trip: d[k] = secret taints d
            self._eval(target.slice, env, fi, summ)
            base = target.value
            name = (
                base.id if isinstance(base, ast.Name) else _dotted(base)
            )
            if name:
                env[name] = env.get(name, CLEAN).merge(tv)

    def _exec_raise(self, st: ast.Raise, env, fi, summ) -> None:
        spec = self.policy.raise_is_sink()
        if st.exc is None:
            return
        tv = self._eval(st.exc, env, fi, summ)
        if spec is None:
            return
        rule, kind = spec
        exc_name = ""
        if isinstance(st.exc, ast.Call):
            exc_name = _dotted(st.exc.func)
        if tv.hot and not fi.pf.is_suppressed(rule, st.lineno):
            self._record_sink(
                rule, kind, exc_name or "raise", st.lineno, tv, fi, summ
            )

    # -- expressions ---------------------------------------------------

    def _eval(self, node, env, fi: FuncInfo, summ: Summary) -> TVal:
        if isinstance(node, ast.Name):
            tv = env.get(node.id)
            if tv is not None:
                return tv
            origin = self.policy.source_name(node.id, fi)
            if origin:
                return TVal(EMPTY, True, origin, (fi.fid,))
            return CLEAN
        if isinstance(node, ast.Attribute):
            dotted = _dotted(node)
            if dotted and dotted in env:
                return env[dotted]
            if self.policy.public_attr(node.attr):
                self._eval(node.value, env, fi, summ)
                return CLEAN
            base = self._eval(node.value, env, fi, summ)
            origin = self.policy.source_name(node.attr, fi)
            if origin and not base.tainted:
                return base.merge(TVal(EMPTY, True, origin, (fi.fid,)))
            return base
        if isinstance(node, ast.Call):
            return self._eval_call(node, env, fi, summ)
        if isinstance(node, (ast.Constant, ast.Lambda)):
            return CLEAN
        if isinstance(node, ast.JoinedStr):
            out = CLEAN
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    out = out.merge(self._eval(v.value, env, fi, summ))
            return out
        if isinstance(node, ast.FormattedValue):
            return self._eval(node.value, env, fi, summ)
        if isinstance(node, (ast.BinOp,)):
            return self._eval(node.left, env, fi, summ).merge(
                self._eval(node.right, env, fi, summ)
            )
        if isinstance(node, ast.BoolOp):
            out = CLEAN
            for v in node.values:
                out = out.merge(self._eval(v, env, fi, summ))
            return out
        if isinstance(node, ast.UnaryOp):
            return self._eval(node.operand, env, fi, summ)
        if isinstance(node, ast.Compare):
            self._eval(node.left, env, fi, summ)
            for c in node.comparators:
                self._eval(c, env, fi, summ)
            return CLEAN  # a comparison result is a bool, not the secret
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            out = CLEAN
            for e in node.elts:
                out = out.merge(self._eval(e, env, fi, summ))
            return out
        if isinstance(node, ast.Dict):
            out = CLEAN
            for v in node.values:
                if v is not None:
                    out = out.merge(self._eval(v, env, fi, summ))
            return out
        if isinstance(node, ast.Subscript):
            self._eval(node.slice, env, fi, summ)
            return self._eval(node.value, env, fi, summ)
        if isinstance(node, ast.Starred):
            return self._eval(node.value, env, fi, summ)
        if isinstance(node, ast.IfExp):
            self._eval(node.test, env, fi, summ)
            return self._eval(node.body, env, fi, summ).merge(
                self._eval(node.orelse, env, fi, summ)
            )
        if isinstance(
            node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)
        ):
            scope = dict(env)
            for gen in node.generators:
                tv = self._eval(gen.iter, scope, fi, summ)
                self._bind(gen.target, tv, scope, fi, summ)
                for cond in gen.ifs:
                    self._eval(cond, scope, fi, summ)
            if isinstance(node, ast.DictComp):
                return self._eval(node.key, scope, fi, summ).merge(
                    self._eval(node.value, scope, fi, summ)
                )
            return self._eval(node.elt, scope, fi, summ)
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self._eval(node.value, env, fi, summ)
        if isinstance(node, ast.Yield):
            if node.value is not None:
                tv = self._eval(node.value, env, fi, summ)
                summ.ret = summ.ret.merge(tv)
                return tv
            return CLEAN
        if isinstance(node, ast.NamedExpr):
            tv = self._eval(node.value, env, fi, summ)
            self._bind(node.target, tv, env, fi, summ)
            return tv
        return CLEAN

    # -- calls -----------------------------------------------------------

    def _eval_call(self, call: ast.Call, env, fi: FuncInfo, summ) -> TVal:
        pol = self.policy
        dotted = _dotted(call.func)
        fid = self.graph.resolve_callee(fi, call.func)
        ctor = False
        if fid is not None and fid in self.index.classes:
            fid = self.index.lookup_method(fid, "__init__")
            ctor = True

        # evaluate arguments (and receiver) first
        arg_tvs: List[TVal] = [
            self._eval(a, env, fi, summ) for a in call.args
        ]
        kw_tvs: Dict[str, TVal] = {
            kw.arg: self._eval(kw.value, env, fi, summ)
            for kw in call.keywords
            if kw.arg is not None
        }
        star_kw = [
            self._eval(kw.value, env, fi, summ)
            for kw in call.keywords
            if kw.arg is None
        ]
        recv = CLEAN
        if isinstance(call.func, ast.Attribute):
            recv = self._eval(call.func.value, env, fi, summ)
        merged = recv
        for tv in arg_tvs + list(kw_tvs.values()) + star_kw:
            merged = merged.merge(tv)

        # sinks first: a call can be both sink and propagator
        sink = pol.sink(call, dotted, fi, fid)
        if sink is not None:
            rule, kind, detail = sink
            if merged.hot and not fi.pf.is_suppressed(rule, call.lineno):
                self._record_sink(
                    rule, kind, detail, call.lineno, merged, fi, summ
                )

        if pol.sanitizer(fid, dotted):
            return CLEAN
        if fid is not None:
            origin = pol.source_call(fid)
            if origin is not None:
                return TVal(EMPTY, True, origin, (fi.fid, fid))
            callee = self.index.functions.get(fid)
            if callee is not None:
                return self._apply_summary(
                    fid, callee, call, arg_tvs, kw_tvs, recv, fi, summ,
                    ctor=ctor,
                )
        if ctor and fid is None:
            # dataclass-style ctor (project class, no explicit __init__):
            # a secret keyword is stored under its own field name and any
            # read re-taints through the taxonomy, so keep the holder
            # object clean instead of smearing every field —
            # cfg = SoakConfig(seed=...) must not taint cfg.n_nodes
            out = recv
            for tv in arg_tvs + star_kw:
                out = out.merge(tv)
            for key, tv in kw_tvs.items():
                if not pol.source_name(key, fi):
                    out = out.merge(tv)
            return out

        # unresolved call: conservatively propagate args + receiver,
        # minus known-clean builtins
        name = dotted.rsplit(".", 1)[-1] if dotted else ""
        if "." not in dotted and pol.cleaner_builtin(name):
            return CLEAN
        # container mutation: d.append(secret) / d.update(...) writes the
        # argument taint back into the receiver binding
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _MUTATORS
        ):
            args_only = CLEAN
            for tv in arg_tvs + list(kw_tvs.values()) + star_kw:
                args_only = args_only.merge(tv)
            if args_only.hot:
                base = _dotted(call.func.value)
                if base:
                    env[base] = env.get(base, CLEAN).merge(args_only)
                    root = base.split(".", 1)[0]
                    if base != root and root not in ("self", "cls"):
                        env[root] = env.get(root, CLEAN).merge(args_only)
        return merged

    def _apply_summary(
        self, fid, callee: FuncInfo, call, arg_tvs, kw_tvs, recv, fi, summ,
        ctor: bool = False,
    ) -> TVal:
        cs = self.summaries.get(fid)
        # map callee params -> caller TVals
        pmap: Dict[str, TVal] = {}
        params = list(callee.params)
        if ctor and params[:1] == ["self"]:
            # C(...) binds a fresh object to self, not the first argument
            pmap[params[0]] = CLEAN
            pos_params = params[1:]
        else:
            recv_style = (
                isinstance(call.func, ast.Attribute)
                and params[:1] in (["self"], ["cls"])
                and self.index.resolve_name_target(
                    fi.pf.rel, _dotted(call.func.value)
                ) not in self.index.classes
            )
            if recv_style:
                pmap[params[0]] = recv
                pos_params = params[1:]
            else:
                pos_params = params
        for p, tv in zip(pos_params, arg_tvs):
            pmap[p] = tv
        for k, tv in kw_tvs.items():
            if k in callee.params:
                pmap[k] = tv

        if cs is None:
            out = CLEAN
            for tv in pmap.values():
                out = out.merge(tv)
            return out

        # conditional sinks in the callee fire when we pass hot args
        for rec in cs.sinks:
            if rec.always:
                continue
            hit = CLEAN
            for p in rec.param_deps:
                tv = pmap.get(p)
                if tv is not None and tv.hot:
                    hit = hit.merge(tv)
            if not hit.hot:
                continue
            if fi.pf.is_suppressed(rec.kind, call.lineno):
                continue
            if hit.tainted:
                self._emit(rec, hit, via=fi)
            else:
                # still symbolic: lift the sink record into our summary
                lifted = hit.deps - {"self", "cls"}
                if lifted:
                    summ.sinks.append(
                        SinkRec(
                            rec.kind, rec.detail, rec.line, rec.path,
                            rec.symbol, lifted, False, rec.origin,
                            (fi.fid,) + rec.chain,
                        )
                    )

        # return taint
        out = CLEAN
        if cs.ret.tainted:
            out = TVal(
                EMPTY, True, cs.ret.origin,
                (fi.fid,) + (cs.ret.chain or (fid,)),
            )
        for p in cs.ret.deps:
            tv = pmap.get(p)
            if tv is not None:
                if tv.tainted:
                    out = out.merge(
                        TVal(tv.deps, True, tv.origin, tv.chain or (fi.fid,))
                    )
                else:
                    out = out.merge(tv)
        if callee.secret_return and not out.tainted:
            out = out.merge(
                TVal(EMPTY, True,
                     f"Secret[...] return of {callee.qualname}",
                     (fi.fid, fid))
            )
        return out

    # -- findings --------------------------------------------------------

    def _record_sink(self, rule, kind, detail, line, tv: TVal, fi, summ):
        rec = SinkRec(
            rule, detail, line, fi.pf.rel, fi.qualname,
            tv.deps, tv.tainted, tv.origin, (fi.fid,),
        )
        if tv.tainted:
            self._emit(rec, tv, via=None)
        # param-conditional: expose to callers too (an in-body source
        # already fired above; both can be true for merged values).
        # `self`/`cls` are excluded — "any caller holding a tainted object
        # reaches every sink in its methods" drowns real chains in noise;
        # attribute sources inside methods still fire directly.
        deps = tv.deps - {"self", "cls"}
        if deps:
            summ.sinks.append(
                SinkRec(rule, detail, line, fi.pf.rel, fi.qualname,
                        deps, False, tv.origin, (fi.fid,))
            )
        _ = kind

    def _emit(self, rec: SinkRec, tv: TVal, via: Optional[FuncInfo]):
        chain = tuple(tv.chain)
        for fid in rec.chain:
            if not chain or chain[-1] != fid:
                chain = chain + (fid,)
        pretty = " -> ".join(
            self.index.functions[f].qualname
            if f in self.index.functions
            else f
            for f in chain
        )
        origin = tv.origin or rec.origin or "secret source"
        key = f"{rec.detail}<-{_origin_token(origin)}"
        f = Finding(
            rule=rec.kind,
            path=rec.path,
            line=rec.line,
            symbol=rec.symbol,
            key=key,
            message=(
                f"secret data ({origin}) reaches {rec.detail}"
                f" [chain: {pretty}]"
            ),
        )
        self.findings.setdefault(f.fingerprint, f)
        _ = via


def _origin_token(origin: str) -> str:
    """Compress an origin description into a stable fingerprint token."""
    for ch in "'\"":
        origin = origin.replace(ch, "")
    return origin.replace(" ", "_")[:48]
