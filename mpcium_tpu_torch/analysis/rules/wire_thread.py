"""MPL5xx — wire & thread hygiene.

MPL501  every dataclass message type in ``wire.py`` must carry a
        ``v`` version field and its ``from_json`` must read it — PR 5
        added SLO fields by luck of the default-tolerant parser; a
        version field makes evolution deliberate. (Byte-compat is
        enforced at runtime by the wire tests: ``v`` is omitted from the
        encoded form while 0, so legacy signed envelopes stay
        bit-identical.)
MPL502  every ``threading.Thread``/``Timer`` constructed in the package
        must be daemonized at the constructor (``daemon=True``), or
        daemonized on the named variable before start, or carry a name
        registered in ``utils.annotations.REGISTERED_THREAD_PREFIXES``
        (the conftest leak-checker exempts those). Anything else leaks
        past interpreter shutdown and trips the tier-1 leak fixture at
        the worst time.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from ..core import Finding, LintContext, ParsedFile, Rule, dotted_name, self_attr

# the registry lives in product code so runtime can use it too
from ...utils.annotations import REGISTERED_THREAD_PREFIXES

_WIRE_FILE = "mpcium_tpu_torch/wire.py"
_THREAD_CTORS = {"threading.Thread", "Thread", "threading.Timer", "Timer"}


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        name = dotted_name(dec if not isinstance(dec, ast.Call) else dec.func)
        if name.rsplit(".", 1)[-1] == "dataclass":
            return True
    return False


class WireVersionRoundTrip(Rule):
    id = "MPL501"
    summary = "wire message types must carry and parse a version field"

    def applies(self, rel: str) -> bool:
        return rel == _WIRE_FILE

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        for cls in pf.tree.body:
            if not isinstance(cls, ast.ClassDef) or not _is_dataclass(cls):
                continue
            has_v = any(
                isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
                and stmt.target.id == "v"
                for stmt in cls.body
            )
            if not has_v:
                yield Finding(
                    rule=self.id,
                    path=pf.rel,
                    line=cls.lineno,
                    symbol=cls.name,
                    key="missing-v",
                    message=(
                        f"wire dataclass {cls.name} has no 'v' version "
                        f"field — add `v: int = 0` (omit from encoding "
                        f"while 0 to stay byte-compatible)"
                    ),
                )
                continue
            from_json = next(
                (
                    m
                    for m in cls.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and m.name == "from_json"
                ),
                None,
            )
            if from_json is not None:
                reads_v = any(
                    isinstance(n, ast.Constant) and n.value == "v"
                    for n in ast.walk(from_json)
                )
                if not reads_v:
                    yield Finding(
                        rule=self.id,
                        path=pf.rel,
                        line=from_json.lineno,
                        symbol=f"{cls.name}.from_json",
                        key="v-not-parsed",
                        message=(
                            f"{cls.name}.from_json never reads the 'v' "
                            f"field — decoded messages silently lose their "
                            f"version"
                        ),
                    )


class UnmanagedThread(Rule):
    id = "MPL502"
    summary = "threads must be daemonized or leak-checker-registered"

    def _registered_name(self, call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                v = kw.value.value
                if isinstance(v, str) and v.startswith(
                    tuple(REGISTERED_THREAD_PREFIXES)
                ):
                    return True
        return False

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        # names daemonized anywhere in the file: `t.daemon = True`,
        # `self._x.daemon = True`
        daemonized: Set[str] = set()
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == "daemon"
                    and isinstance(node.value, ast.Constant)
                    and node.value.value is True
                ):
                    owner = t.value
                    if isinstance(owner, ast.Name):
                        daemonized.add(owner.id)
                    else:
                        sa = self_attr(owner)
                        if sa:
                            daemonized.add(sa)
        for node in ast.walk(pf.tree):
            ctor: Optional[ast.Call] = None
            bound: List[str] = []
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                ctor = node.value
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        bound.append(t.id)
                    else:
                        sa = self_attr(t)
                        if sa:
                            bound.append(sa)
            elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                ctor = node.value
            if ctor is None or dotted_name(ctor.func) not in _THREAD_CTORS:
                continue
            daemon_kw = any(
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in ctor.keywords
            )
            if daemon_kw or self._registered_name(ctor):
                continue
            if any(b in daemonized for b in bound):
                continue
            kind = dotted_name(ctor.func).rsplit(".", 1)[-1]
            yield Finding(
                rule=self.id,
                path=pf.rel,
                line=ctor.lineno,
                symbol=pf.symbol_of(node),
                key=f"{kind}:{bound[0] if bound else 'anonymous'}",
                message=(
                    f"{kind} created without daemon=True and not registered "
                    f"with the leak-checker (utils.annotations."
                    f"REGISTERED_THREAD_PREFIXES) — it will outlive shutdown"
                ),
            )
