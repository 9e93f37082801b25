"""MPF8xx: device-residency analysis + the host-transfer budget (the
port's counterpart of the JAX package's ``analysis/flow/residency.py``,
with torch's host syncs in place of JAX's).

A function is **device-hot** when it is reachable (over the project call
graph) from a protocol-phase entry point — the orchestration methods
that drive the device (``OTMtALeg.run_multi``,
``BatchedCoSigners.sign``, ``BatchedECDSASigningParty.receive``, …).
Inside device-hot functions, every *host materialization* — a point
where the host waits for the card — is a site:

  - ``x.cpu()``, ``x.to("cpu")``, ``x.numpy()`` (JAX's
    ``jax.device_get``), ``torch.cuda.synchronize(...)`` and
    ``<event or stream>.synchronize()`` (JAX's
    ``x.block_until_ready()``) — always;
  - ``x.item()`` — always (a device scalar pulled to Python);
  - ``np.asarray(x)`` / ``np.array(x)`` / ``x.tolist()`` /
    ``bool(x)`` / ``int(x)`` / ``float(x)`` — when ``x`` is
    device-tracked (bound from a ``torch.*`` call that yields a tensor,
    a method of a device value, a project function annotated
    ``-> torch.Tensor``, a ``torch.Tensor``-annotated param, or the
    ``*_d`` naming convention).

Implicit syncs (``if t:``, ``torch.equal``, a CUDA tensor's
``__index__``) are not counted: the sweep sees only the spelled-out
forms above.

A site annotated ``# mpcflow: host-ok — reason`` is *intentional*: it
raises no finding but is counted in the budget with its reason, so wire
boundaries stay visible without blocking CI. Unannotated sites raise
MPF801 (fix, annotate, or baseline with a justification naming the
ROADMAP item that deletes it).

``build_budget`` emits the per-phase machine-readable budget that
``scripts/torch_mpcflow_budget.py`` writes to
``mpcium_tpu_torch/data/host_transfer_budget.json`` and the tier-1 gate
diffs against the committed copy: the file only ever shrinks.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core import Finding
from .callgraph import CallGraph, _nested_ids
from .symbols import FuncInfo, ProjectIndex, _dotted

RULE = "MPF801"

# phase -> orchestration entry fids (order matters: a function reachable
# from several phases is budgeted under the first one that claims it)
PHASE_ENTRY_POINTS: Dict[str, Tuple[str, ...]] = {
    "ecdsa.mta_ot": (
        "mpcium_tpu_torch/protocol/ecdsa/mta_ot.py::OTMtALeg.__init__",
        "mpcium_tpu_torch/protocol/ecdsa/mta_ot.py::OTMtALeg.run_multi",
        "mpcium_tpu_torch/protocol/ecdsa/mta_ot.py::OTMtALeg.run",
        "mpcium_tpu_torch/protocol/ecdsa/mta_ot.py::OTMtALeg.alice_round1",
        "mpcium_tpu_torch/protocol/ecdsa/mta_ot.py::OTMtALeg.bob_round2_multi",
        "mpcium_tpu_torch/protocol/ecdsa/mta_ot.py::OTMtALeg.alice_round3_multi",
    ),
    "ecdsa.sign": (
        "mpcium_tpu_torch/engine/gg18_batch.py::GG18BatchCoSigners.sign",
        # parties are constructed once per batch: __init__ is hot too
        "mpcium_tpu_torch/protocol/ecdsa/batch_signing.py::"
        "BatchedECDSASigningParty.__init__",
        "mpcium_tpu_torch/protocol/ecdsa/batch_signing.py::"
        "BatchedECDSASigningParty.start",
        "mpcium_tpu_torch/protocol/ecdsa/batch_signing.py::"
        "BatchedECDSASigningParty.receive",
    ),
    "eddsa.sign": (
        "mpcium_tpu_torch/engine/eddsa_batch.py::BatchedCoSigners.sign",
        "mpcium_tpu_torch/engine/sharded.py::sharded_sign",
    ),
    "dkg": (
        "mpcium_tpu_torch/engine/dkg_batch.py::BatchedDKG.run",
        "mpcium_tpu_torch/engine/dkg_batch.py::BatchedReshare.run",
        "mpcium_tpu_torch/protocol/batch_dkg.py::BatchedDKGParty.__init__",
        "mpcium_tpu_torch/protocol/batch_dkg.py::BatchedDKGParty.start",
        "mpcium_tpu_torch/protocol/batch_dkg.py::BatchedDKGParty.receive",
        "mpcium_tpu_torch/protocol/batch_dkg.py::BatchedReshareParty.__init__",
        "mpcium_tpu_torch/protocol/batch_dkg.py::BatchedReshareParty.start",
        "mpcium_tpu_torch/protocol/batch_dkg.py::BatchedReshareParty.receive",
    ),
    "keygen.dealer": (
        "mpcium_tpu_torch/engine/eddsa_batch.py::dealer_keygen_batch",
        "mpcium_tpu_torch/engine/gg18_batch.py::dealer_keygen_secp_batch",
    ),
}

# only code in these trees can be device-hot; serialization helpers in
# wire.py / node/ that a phase reaches operate on host values by design
_HOT_SCOPES = (
    "mpcium_tpu_torch/engine/",
    "mpcium_tpu_torch/ops/",
    "mpcium_tpu_torch/protocol/",
)

# torch.* calls that yield something other than a tensor
_TORCH_HOST_CALLS = (
    "torch.cuda.", "torch.backends.", "torch.profiler.", "torch.distributed.",
    "torch.utils.", "torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
    "torch.equal", "torch.is_", "torch.no_grad", "torch.inference_mode",
    "torch.set_", "torch.get_", "torch.manual_seed", "torch.Generator",
)
_MATERIALIZERS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SCALARIZERS = {"bool", "int", "float"}
_COMPS = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)
# methods whose result lives on the host (the sync sites themselves)
_HOST_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# tensor metadata: host values read without a sync
_HOST_META = {
    "shape", "dtype", "device", "ndim", "is_cuda", "size", "numel", "dim",
    "stride", "element_size", "data_ptr", "nbytes", "itemsize",
    "is_contiguous", "get_device",
}


class Site:
    __slots__ = ("phase", "path", "symbol", "line", "kind", "detail",
                 "intentional", "reason")

    def __init__(self, phase, path, symbol, line, kind, detail,
                 intentional, reason):
        self.phase = phase
        self.path = path
        self.symbol = symbol
        self.line = line
        self.kind = kind
        self.detail = detail
        self.intentional = intentional
        self.reason = reason

    def budget_row(self) -> Dict[str, object]:
        row: Dict[str, object] = {
            "path": self.path,
            "symbol": self.symbol,
            "kind": self.kind,
            "detail": self.detail,
            "intentional": self.intentional,
        }
        if self.reason:
            row["reason"] = self.reason
        return row


def _annotation_is_device(ann) -> bool:
    """True when the annotation mentions ``torch.Tensor`` anywhere —
    covers plain ``torch.Tensor``, ``Tuple[torch.Tensor, ...]``, and the
    string form."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return "torch.Tensor" in ann.value
    return any(_dotted(node) == "torch.Tensor" for node in ast.walk(ann))


def _torch_yields_tensor(dotted: str) -> bool:
    return dotted.startswith("torch.") and not dotted.startswith(
        _TORCH_HOST_CALLS
    )


def _is_to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    args = list(call.args[:1]) + [
        kw.value for kw in call.keywords if kw.arg == "device"
    ]
    return any(
        isinstance(a, ast.Constant) and a.value == "cpu" for a in args
    )


def device_fn_names(index: ProjectIndex) -> Set[str]:
    """Project function names that *consistently* return device values
    (``torch.Tensor``-annotated everywhere the name is defined).

    Covers calls the graph can't resolve because the callee module is a
    runtime value — ``mod, _ = _curve(key_type); mod.decompress(...)``:
    ``decompress`` is device-returning in both curve modules, so the
    unresolved call is still tracked. Names defined with conflicting
    device-ness anywhere in the project are excluded."""
    seen: Dict[str, Optional[bool]] = {}
    for fi in index.functions.values():
        name = fi.qualname.rsplit(".", 1)[-1]
        is_dev = _annotation_is_device(fi.node.returns)
        if name in seen and seen[name] != is_dev:
            seen[name] = None
        else:
            seen[name] = is_dev
    return {n for n, v in seen.items() if v}


class _DeviceTracker:
    """Order-insensitive local device-value inference for one function."""

    def __init__(self, fi: FuncInfo, index: ProjectIndex, graph: CallGraph,
                 dev_names: Optional[Set[str]] = None):
        self.fi = fi
        self.index = index
        self.graph = graph
        self.dev_names = dev_names if dev_names is not None else set()
        self.names: Set[str] = set()
        a = fi.node.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if _annotation_is_device(p.annotation) or p.arg.endswith("_d"):
                self.names.add(p.arg)
        # fixpoint over assignments (bodies are small; 2-3 passes settle)
        assigns = [
            n for n in ast.walk(fi.node)
            if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))
        ]
        # comprehension targets over a device iterable — the per-device
        # pieces of a sharded batch: [bool(f) for f in oks]
        gens = [
            g for n in ast.walk(fi.node) if isinstance(n, _COMPS)
            for g in n.generators
        ]
        for _ in range(4):
            changed = False
            for st in assigns + gens:
                value = getattr(st, "value", None) or getattr(st, "iter", None)
                if value is None or not self.is_device(value):
                    continue
                targets = (
                    st.targets if isinstance(st, ast.Assign) else [st.target]
                )
                for t in targets:
                    for leaf in self._target_names(t):
                        if leaf not in self.names:
                            self.names.add(leaf)
                            changed = True
            if not changed:
                break

    def _target_names(self, t):
        if isinstance(t, ast.Name):
            yield t.id
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                yield from self._target_names(e)
        elif isinstance(t, ast.Starred):
            yield from self._target_names(t.value)
        elif isinstance(t, ast.Attribute):
            d = _dotted(t)
            if d:
                yield d

    def is_device(self, e) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names or e.id.endswith("_d")
        if isinstance(e, ast.Attribute):
            d = _dotted(e)
            if d and (d in self.names or d.endswith("_d")):
                return True
            if e.attr in _HOST_META:
                return False
            return self.is_device(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_device(e.value)
        if isinstance(e, ast.Call):
            dotted = _dotted(e.func)
            if dotted.startswith("torch."):
                return _torch_yields_tensor(dotted)
            if dotted in _MATERIALIZERS or _is_to_cpu(e):
                return False  # result is a host value
            fid = self.graph.resolve_callee(self.fi, e.func)
            if fid is not None:
                callee = self.index.functions.get(fid)
                if callee is not None and _annotation_is_device(
                    callee.node.returns
                ):
                    return True
            elif (
                isinstance(e.func, ast.Attribute)
                and e.func.attr in self.dev_names
            ):
                return True
            # method call on a device value keeps device-ness (.reshape…)
            if isinstance(e.func, ast.Attribute) and e.func.attr not in (
                _HOST_METHODS | _HOST_META
            ):
                return self.is_device(e.func.value)
            return False
        if isinstance(e, (ast.Tuple, ast.List)):
            return any(self.is_device(x) for x in e.elts)
        if isinstance(e, ast.BinOp):
            return self.is_device(e.left) or self.is_device(e.right)
        if isinstance(e, ast.IfExp):
            return self.is_device(e.body) or self.is_device(e.orelse)
        if isinstance(e, (ast.Await, ast.Starred)):
            return self.is_device(e.value)
        if isinstance(e, (ast.ListComp, ast.GeneratorExp)):
            return self.is_device(e.elt)
        return False


def _reachable_with_closures(
    index: ProjectIndex, graph: CallGraph, roots: Set[str]
) -> Set[str]:
    """Call-graph closure of ``roots`` in which a def nested in a
    reached function is reached too: the engines hand their cohort jobs
    (``def run(): ...``) to a runner instead of calling them by name."""
    nested: Dict[str, List[str]] = {}
    for fid, fi in index.functions.items():
        if fi.parent_fid:
            nested.setdefault(fi.parent_fid, []).append(fid)
    reached: Set[str] = set()
    frontier = set(roots)
    while frontier:
        reached |= graph.reachable_from(frontier)
        frontier = {
            c for fid in reached for c in nested.get(fid, ())
        } - reached
    return reached


def classify_hot(index: ProjectIndex, graph: CallGraph) -> Dict[str, str]:
    """fid -> phase for every device-hot function (first phase wins)."""
    hot: Dict[str, str] = {}
    for phase, entries in PHASE_ENTRY_POINTS.items():
        roots = {e for e in entries if e in index.functions}
        for fid in _reachable_with_closures(index, graph, roots):
            fi = index.functions[fid]
            if not fi.pf.rel.startswith(_HOT_SCOPES):
                continue
            hot.setdefault(fid, phase)
    return hot


def _arg_detail(e) -> str:
    d = _dotted(e)
    if d:
        return d
    if isinstance(e, ast.Call):
        return _dotted(e.func) or type(e).__name__
    if isinstance(e, ast.Subscript):
        return _arg_detail(e.value) + "[]"
    return type(e).__name__


def _root_name(e) -> str:
    """The name an expression hangs off: ``t`` for ``t.detach().to(...)``."""
    while isinstance(e, (ast.Attribute, ast.Call, ast.Subscript)):
        e = e.func if isinstance(e, ast.Call) else e.value
    return e.id if isinstance(e, ast.Name) else ""


def _own_nodes(fi: FuncInfo):
    """The nodes of ``fi``'s body, nested defs excluded (they have fids
    of their own)."""
    nested = _nested_ids(fi)
    return [n for n in ast.walk(fi.node) if id(n) not in nested]


class _LazyTracker:
    """A :class:`_DeviceTracker` built on the first question: most
    bodies never ask one."""

    def __init__(self, fi, index, graph, dev_names):
        self.args = (fi, index, graph, dev_names)
        self._t: Optional[_DeviceTracker] = None

    def is_device(self, e) -> bool:
        if self._t is None:
            self._t = _DeviceTracker(*self.args)
        return self._t.is_device(e)


def _bound_arg(call: ast.Call, callee: FuncInfo, param: str):
    """The argument expression ``call`` binds to ``callee``'s ``param``."""
    for kw in call.keywords:
        if kw.arg == param:
            return kw.value
    pos = callee.params.index(param)
    if callee.params[:1] in (["self"], ["cls"]) and isinstance(
        call.func, ast.Attribute
    ):
        pos -= 1
    return call.args[pos] if 0 <= pos < len(call.args) else None


def _param_is_device(fi: FuncInfo, param: str) -> bool:
    a = fi.node.args
    return any(
        p.arg == param and _annotation_is_device(p.annotation)
        for p in a.posonlyargs + a.args + a.kwonlyargs
    )


def _raw_sites(
    fi: FuncInfo, tracker: _LazyTracker, graph: CallGraph,
    helpers: Dict[str, Tuple[str, str]], nodes=None,
):
    """(call node, kind, detail, pulled expression) for every host
    materialization in ``fi``'s own body; a call to a host helper is one,
    of the helper's kind, pulling the argument the helper pulls."""
    for node in nodes if nodes is not None else _own_nodes(fi):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        arg0 = node.args[0] if node.args else None
        if dotted == "torch.cuda.synchronize":
            yield (node, "synchronize",
                   _arg_detail(arg0) if arg0 else "torch.cuda", arg0)
            continue
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            recv = node.func.value
            kind = None
            if attr in ("synchronize", "cpu", "item") and not node.args:
                kind = attr
            elif _is_to_cpu(node):
                kind = "to_cpu"
            elif attr == "numpy" and not node.args and not (
                # x.cpu().numpy() is one transfer, counted at .cpu()
                isinstance(recv, ast.Call)
                and (_is_to_cpu(recv) or (
                    isinstance(recv.func, ast.Attribute)
                    and recv.func.attr == "cpu"
                ))
            ):
                kind = "numpy"
            elif attr == "tolist" and tracker.is_device(recv):
                kind = "tolist"
            if kind is not None:
                yield node, kind, _arg_detail(recv), recv
                continue
        if dotted in _MATERIALIZERS or dotted in _SCALARIZERS:
            if arg0 is not None and tracker.is_device(arg0):
                kind = "np.asarray" if dotted in _MATERIALIZERS else f"{dotted}()"
                yield node, kind, _arg_detail(arg0), arg0
            continue
        if not helpers:
            continue
        fid = graph.resolve_callee(fi, node.func)
        if fid in helpers:
            kind, param = helpers[fid]
            callee = graph.index.functions[fid]
            pulled = _bound_arg(node, callee, param)
            # a helper that declares a tensor parameter is handed one
            if pulled is not None and (
                _param_is_device(callee, param) or tracker.is_device(pulled)
            ):
                yield node, kind, _arg_detail(pulled), pulled


def _loop_param(fi: FuncInfo, name: str) -> str:
    """The parameter a loop or comprehension variable ``name`` walks."""
    for n in _own_nodes(fi):
        gens = n.generators if isinstance(n, _COMPS) else (
            [n] if isinstance(n, (ast.For, ast.AsyncFor)) else []
        )
        for g in gens:
            if any(isinstance(t, ast.Name) and t.id == name
                   for t in ast.walk(g.target)):
                root = _root_name(g.iter)
                return root if root in fi.params else _loop_param(fi, root)
    return name


def _param_rooted(fi: FuncInfo) -> Set[str]:
    """``fi``'s parameters (not self/cls), with the loop and
    comprehension variables that walk them."""
    names = set(fi.params) - {"self", "cls"}
    loops = [
        (g.target, g.iter) for n in _own_nodes(fi) if isinstance(n, _COMPS)
        for g in n.generators
    ] + [
        (n.target, n.iter) for n in _own_nodes(fi)
        if isinstance(n, (ast.For, ast.AsyncFor))
    ]
    for target, it in loops:
        if _root_name(it) in names:
            names |= {
                t.id for t in ast.walk(target) if isinstance(t, ast.Name)
            }
    return names


def _host_ok_reason(pf, line: int) -> Optional[str]:
    reason = pf.host_ok.get(line)
    if reason is None:
        reason = pf.host_ok.get(line - 1)  # comment-above style
    return reason


def host_helpers(
    index: ProjectIndex, graph: CallGraph, dev_names: Set[str]
) -> Dict[str, Tuple[str, str]]:
    """fid -> (site kind, pulled param) for the project's host helpers:
    functions whose body pulls one argument to the host at exactly one
    unannotated site (``def _host(t): return t.cpu().numpy()``). A call
    to one is the site, counted where the call is — one site per wire
    field, as the JAX package counts its inline ``np.asarray`` — and the
    helper's own body counts nothing. A ``host-ok`` site makes no
    helper, and neither does a phase entry point: each is counted, with
    its reason, where it stands."""
    helpers: Dict[str, Tuple[str, str]] = {}
    entries = {fid for fids in PHASE_ENTRY_POINTS.values() for fid in fids}
    calls = {
        fi.fid: [n for n in _own_nodes(fi) if isinstance(n, ast.Call)]
        for fi in index.functions.values()
        if fi.params and fi.fid not in entries
    }
    for _ in range(4):  # helpers of helpers (bn.batch_from_limbs)
        found: Dict[str, Tuple[str, str]] = {}
        for fid, nodes in calls.items():
            fi = index.functions[fid]
            tracker = _LazyTracker(fi, index, graph, dev_names)
            raw = list(_raw_sites(fi, tracker, graph, helpers, nodes))
            if len(raw) != 1 or raw[0][3] is None:
                continue
            node, _kind, _detail, pulled = raw[0]
            root = _root_name(pulled)
            if root in _param_rooted(fi) and _host_ok_reason(
                fi.pf, node.lineno
            ) is None:
                param = root if root in fi.params else _loop_param(fi, root)
                found[fi.fid] = (
                    fi.qualname.rsplit(".", 1)[-1] + "()", param
                )
        if found == helpers:
            break
        helpers = found
    return helpers


def scan_function(
    fi: FuncInfo, phase: str, index: ProjectIndex, graph: CallGraph,
    dev_names: Optional[Set[str]] = None,
    helpers: Optional[Dict[str, Tuple[str, str]]] = None,
) -> List[Site]:
    helpers = helpers or {}
    if fi.fid in helpers:
        return []  # counted at each call site
    tracker = _LazyTracker(fi, index, graph, dev_names)
    sites: List[Site] = []
    for node, kind, detail, _pulled in _raw_sites(fi, tracker, graph, helpers):
        line = node.lineno
        reason = _host_ok_reason(fi.pf, line)
        sites.append(
            Site(phase, fi.pf.rel, fi.qualname, line, kind, detail,
                 reason is not None, reason or "")
        )
    return sites


def run_residency(
    index: ProjectIndex, graph: CallGraph
) -> Tuple[List[Finding], List[Site]]:
    hot = classify_hot(index, graph)
    dev_names = device_fn_names(index)
    helpers = host_helpers(index, graph, dev_names)
    all_sites: List[Site] = []
    findings: List[Finding] = []
    for fid, phase in sorted(hot.items()):
        fi = index.functions[fid]
        for site in scan_function(fi, phase, index, graph, dev_names, helpers):
            all_sites.append(site)
            if site.intentional:
                continue
            if fi.pf.is_suppressed(RULE, site.line):
                continue
            f = Finding(
                rule=RULE,
                path=site.path,
                line=site.line,
                symbol=site.symbol,
                key=f"{site.kind}:{site.detail}",
                message=(
                    f"host materialization ({site.kind} of {site.detail}) "
                    f"on device-hot path [phase {phase}] — fix, annotate "
                    f"'# mpcflow: host-ok — reason', or baseline against "
                    f"a ROADMAP item"
                ),
            )
            findings.append(f)
    # dedupe by fingerprint (same kind+detail can appear twice in a body)
    uniq: Dict[str, Finding] = {}
    for f in findings:
        uniq.setdefault(f.fingerprint, f)
    return (
        sorted(uniq.values(), key=lambda f: (f.path, f.line, f.rule, f.key)),
        all_sites,
    )


def build_budget(sites: Sequence[Site]) -> Dict[str, object]:
    """The machine-readable host-transfer budget (line-number free so the
    committed JSON survives unrelated edits)."""
    phases: Dict[str, Dict[str, object]] = {}
    seen: Set[Tuple[str, str, str, str, str]] = set()
    for s in sorted(
        sites, key=lambda s: (s.phase, s.path, s.symbol, s.kind, s.detail)
    ):
        k = (s.phase, s.path, s.symbol, s.kind, s.detail)
        if k in seen:
            continue
        seen.add(k)
        ph = phases.setdefault(
            s.phase,
            {"total_sites": 0, "intentional": 0, "tracked": 0, "sites": []},
        )
        ph["total_sites"] += 1  # type: ignore[operator]
        if s.intentional:
            ph["intentional"] += 1  # type: ignore[operator]
        else:
            ph["tracked"] += 1  # type: ignore[operator]
        ph["sites"].append(s.budget_row())  # type: ignore[union-attr]
    return {
        "comment": (
            "Host-transfer budget per protocol phase (mpcflow MPF801). "
            "'intentional' sites carry a '# mpcflow: host-ok' reason "
            "(wire boundaries); 'tracked' sites are baselined debt tied "
            "to ROADMAP items and must monotonically shrink. Regenerate "
            "with scripts/torch_mpcflow_budget.py."
        ),
        "phases": phases,
    }
