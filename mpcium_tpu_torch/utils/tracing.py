"""mpctrace for the port: the span model of the JAX package's
``utils/tracing.py`` (the port's copy), plus the engines' phase timer.

Span identity is ``trace_id`` / ``span_id`` / ``parent_id``; clocks are
``time.monotonic_ns`` so spans from every node of an in-process cluster
share one timebase. Attributes are public metadata only: names that hit
the secret taxonomy (``analysis/taxonomy.py``) are refused unless the
name was declassified with a reason (:func:`declassify_attr`).

Disabled (the default), :func:`span` returns a shared inert singleton
and :func:`emit`, :func:`instant` and :func:`incident` return at once,
so an untraced run does exactly the same work. :func:`enable` installs
a sink that receives each finished span as a dict ``{name, trace_id,
span_id, parent_id, node, tid, t0_ns, t1_ns, kind, attrs}``. The
incident hook (:func:`set_incident_hook`) is where a flight recorder
would attach; the port installs none yet. Ids come from a process-local
counter and a keyed hash of public names (:func:`trace_id_for`), so a
traced run makes the same decisions as an untraced one.

:class:`PhaseTimer` is the engines' phase instrumentation, with the JAX
package's signature and spans (``phase:<name>``); its sync is
:func:`sync_tensors`. :func:`span_sync` is the port's own: inside a span
it synchronizes the device so the span is honest device time, only while
tracing is on. Under an armed session mesh
(``engine/eddsa_batch.arm_session_sharding`` calls
:func:`set_mesh_devices`) both synchronize every mesh device as well, or
a span would time shard 0 alone. :func:`phase_share` and
:func:`device_idle_fraction` fold recorded spans back into a phase table
and the share of the traced window outside every phase.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

now_ns = time.monotonic_ns

# -- the no-op fast path gate -------------------------------------------------
_ENABLED = False
_sink: Optional[Callable[[dict], None]] = None
_incident_hook: Optional[Callable[[str, str, dict], None]] = None

_ids = itertools.count(1)
_state = threading.local()  # .stack: List[Span] of open spans in this thread

# attribute names that hit the secret taxonomy but were reviewed as
# public metadata; name -> reason (the declassify registry, runtime half)
_DECLASSIFIED_ATTRS: Dict[str, str] = {}

_ATTR_SCALARS = (str, int, float, bool, type(None))


def enabled() -> bool:
    return _ENABLED


def enable(sink: Optional[Callable[[dict], None]] = None) -> None:
    """Turn tracing on. ``sink`` is called with each finished span dict;
    without one, spans only feed context propagation (log correlation,
    wire context) and are otherwise discarded."""
    global _ENABLED, _sink
    _sink = sink
    _ENABLED = True


def disable() -> None:
    global _ENABLED, _sink, _incident_hook
    _ENABLED = False
    _sink = None
    _incident_hook = None


def set_incident_hook(hook: Optional[Callable[[str, str, dict], None]]) -> None:
    """Install the incident callback: ``hook(kind, node, attrs)``. The
    flight recorder uses it to dump buffers on shed/timeout/failure."""
    global _incident_hook
    _incident_hook = hook


def declassify_attr(name: str, reason: str) -> None:
    """Register a taxonomy-hitting attribute name as reviewed-public.
    The reason is mandatory and kept for the audit surface."""
    if not reason or not reason.strip():
        raise ValueError(f"declassify_attr({name!r}) requires a reason")
    _DECLASSIFIED_ATTRS[name] = reason


def declassified_attrs() -> Dict[str, str]:
    return dict(_DECLASSIFIED_ATTRS)


def _is_secret_attr(name: str) -> bool:
    # lazy import, as in the JAX package: tracing imports nothing of the
    # project at load time, so every layer can depend on it
    from ..analysis.taxonomy import is_secret_name

    return is_secret_name(name)


def clean_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Attribute hygiene: secret-taxonomy names are refused (value
    replaced with a marker, the value itself never retained) unless
    declassified; non-scalar values are reduced to their type name so no
    object repr can smuggle key material into a trace."""
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if k not in _DECLASSIFIED_ATTRS and _is_secret_attr(k):
            out[k] = "<refused:secret-name>"
            continue
        if isinstance(v, _ATTR_SCALARS):
            out[k] = v
        else:
            out[k] = f"<obj:{type(v).__name__}>"
    return out


def trace_id_for(name: str) -> str:
    """Deterministic trace id from a public name (session id, drill
    name): every node derives the same id for the same session without
    coordination, so merged views group correctly even for spans that
    never rode a wire envelope."""
    return hashlib.sha256(b"mpctrace|" + name.encode()).hexdigest()[:16]


def _next_span_id() -> str:
    return f"{next(_ids):016x}"


def _stack() -> List["Span"]:
    st = getattr(_state, "stack", None)
    if st is None:
        st = []
        _state.stack = st
    return st


class Span:
    """An open span. Finish with ``end()`` or use ``span()`` as a
    context manager. Not thread-safe; a span belongs to one thread."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "node", "tid", "t0_ns", "t1_ns", "kind", "attrs", "_pushed",
    )

    def __init__(
        self,
        name: str,
        *,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        node: str = "local",
        tid: str = "main",
        kind: str = "X",
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        st = _stack()
        top = st[-1] if st else None
        self.name = name
        self.trace_id = trace_id or (top.trace_id if top else trace_id_for(name))
        self.parent_id = parent_id if parent_id is not None else (
            top.span_id if top else None
        )
        self.span_id = _next_span_id()
        # "local"/"main" are the unset sentinels: inherit from the
        # enclosing span so nested spans land on the right track
        self.node = top.node if (node == "local" and top is not None) else node
        self.tid = top.tid if (tid == "main" and top is not None) else tid
        self.t0_ns = now_ns()
        self.t1_ns = 0
        self.kind = kind
        self.attrs = clean_attrs(attrs) if attrs else {}
        self._pushed = False

    def set(self, **attrs: Any) -> None:
        self.attrs.update(clean_attrs(attrs))

    def end(self) -> None:
        self.t1_ns = now_ns()
        sink = _sink
        if sink is not None:
            sink(_span_dict(self))

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._pushed = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._pushed:
            st = _stack()
            if st and st[-1] is self:
                st.pop()
            elif self in st:  # defensive: unbalanced exit
                st.remove(self)
            self._pushed = False
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.end()


class _NoopSpan:
    """Shared inert span for the disabled fast path."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def set(self, **attrs: Any) -> None:
        return None

    def end(self) -> None:
        return None


NOOP_SPAN = _NoopSpan()


_SPAN_KW = ("trace_id", "parent_id", "node", "tid", "kind", "attrs")


def span(name: str, **kw: Any):
    """Open a span (context manager). Known keywords (``trace_id``,
    ``parent_id``, ``node``, ``tid``, ``kind``, ``attrs``) configure the
    span; anything else becomes an attribute. No-op singleton when
    disabled — the fast path is this one flag check."""
    if not _ENABLED:
        return NOOP_SPAN
    cfg = {k: kw.pop(k) for k in _SPAN_KW if k in kw}
    if kw:
        cfg["attrs"] = {**kw, **(cfg.get("attrs") or {})}
    return Span(name, **cfg)


def _span_dict(s: Span) -> dict:
    return {
        "name": s.name,
        "trace_id": s.trace_id,
        "span_id": s.span_id,
        "parent_id": s.parent_id,
        "node": s.node,
        "tid": s.tid,
        "t0_ns": s.t0_ns,
        "t1_ns": s.t1_ns,
        "kind": s.kind,
        "attrs": s.attrs,
    }


def emit(
    name: str,
    t0_ns: int,
    t1_ns: int,
    *,
    node: str = "local",
    tid: str = "main",
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    kind: str = "X",
    **attrs: Any,
) -> None:
    """Record an already-finished interval as a span (retroactive form:
    the scheduler turns queue-entry lifetimes into spans at dispatch or
    shed time without holding live span objects in its entries)."""
    if not _ENABLED:
        return
    sink = _sink
    if sink is None:
        return
    sink({
        "name": name,
        "trace_id": trace_id or trace_id_for(name),
        "span_id": _next_span_id(),
        "parent_id": parent_id,
        "node": node,
        "tid": tid,
        "t0_ns": int(t0_ns),
        "t1_ns": int(t1_ns),
        "kind": kind,
        "attrs": clean_attrs(attrs) if attrs else {},
    })


def instant(name: str, *, node: str = "local", tid: str = "main",
            trace_id: Optional[str] = None, **attrs: Any) -> None:
    """Zero-duration marker event."""
    if not _ENABLED:
        return
    t = now_ns()
    emit(name, t, t, node=node, tid=tid, trace_id=trace_id, kind="i", **attrs)


def incident(kind: str, *, node: str = "local", tid: str = "main",
             **attrs: Any) -> None:
    """Mark an operational incident (shed, timeout, drill failure).
    Emits an instant span and fires the flight-recorder dump hook."""
    if not _ENABLED:
        return
    instant(f"incident:{kind}", node=node, tid=tid, **attrs)
    hook = _incident_hook
    if hook is not None:
        hook(kind, node, clean_attrs(attrs) if attrs else {})


def current_ids() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the innermost open span in this thread,
    or None. Used by utils.log for log/trace correlation."""
    if not _ENABLED:
        return None
    st = getattr(_state, "stack", None)
    if not st:
        return None
    top = st[-1]
    return (top.trace_id, top.span_id)


def wire_context() -> Optional[Dict[str, str]]:
    """Trace context in wire form ({"t": trace_id, "s": span_id}) for
    the optional envelope field, or None when no span is open."""
    ids = current_ids()
    if ids is None:
        return None
    return {"t": ids[0], "s": ids[1]}


_MESH_DEVICES: Tuple[torch.device, ...] = ()


def set_mesh_devices(devices) -> None:
    """The armed session mesh's devices, which every sync covers too."""
    global _MESH_DEVICES
    _MESH_DEVICES = tuple(devices)


def _sync(devices) -> None:
    """Synchronize each CUDA device, outside any CUDA graph capture (a
    device-wide synchronize while another thread captures would fail
    both: ``engine/graphs.no_capture``)."""
    from ..engine.graphs import no_capture

    for d in dict.fromkeys(tuple(devices) + _MESH_DEVICES):
        if d.type == "cuda":
            with no_capture():
                torch.cuda.synchronize(d)


def _tensor_devices(tree, out: list) -> list:
    if isinstance(tree, torch.Tensor):
        out.append(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensor_devices(v, out)
    elif isinstance(tree, (list, tuple)):  # lists of pieces, point tuples
        for v in tree:
            _tensor_devices(v, out)
    return out


def sync_tensors(tensors) -> None:
    """The engines' phase-boundary sync (the JAX package's
    ``block_until_ready``): finish the work queued on every device that
    holds one of ``tensors`` (tensors, or lists, tuples and dicts of
    them) and on every device of the armed mesh."""
    _sync(_tensor_devices(tensors, []))


def span_sync(device: torch.device) -> None:
    """Finish the device work queued inside a span before it closes, so
    the span is honest device time — only while tracing is on."""
    if _ENABLED:
        _sync((device,))


class PhaseTimer:
    """Engine-side phase instrumentation (the JAX package's
    ``PhaseTimer``): device-phase spans with a sync at each phase
    boundary, ONLY when tracing is on or a ``phase_times`` dict was
    asked for. ``sync`` is supplied by the engine (:func:`sync_tensors`).

    ``mark(name, *tensors, **attrs)`` closes the interval since the
    previous mark as a span ``phase:<name>`` with the numeric ``attrs``,
    and sets ``phase_times[name]`` to its seconds (and each numeric attr
    as ``<name>_<attr>``). Off, ``mark`` is one attribute load and a
    return: no sync, no allocation. :meth:`restart` is the port's own: a
    cohort that resumes after a host stage starts its next phase then,
    so the wait for other cohorts counts in none of its phases."""

    __slots__ = ("on", "phases", "_sync", "node", "tid", "trace_id",
                 "parent_id", "last_ns")

    def __init__(
        self,
        engine: str,
        sync: Callable[..., Any],
        *,
        phase_times: Optional[Dict[str, float]] = None,
        node: str = "local",
        tid: Optional[str] = None,
    ) -> None:
        self.on = _ENABLED or phase_times is not None
        self.phases = phase_times
        self._sync = sync
        self.node = node
        self.tid = tid or engine
        self.trace_id = trace_id_for(engine) if self.on else None
        ids = current_ids()
        self.parent_id = ids[1] if ids else None
        if ids:
            self.trace_id = ids[0]
        self.last_ns = now_ns() if self.on else 0

    def mark(self, name: str, *tensors: Any, **attrs: Any) -> None:
        if not self.on:
            return
        if tensors:
            self._sync(tensors)
        t = now_ns()
        if self.phases is not None:
            self.phases[name] = (t - self.last_ns) / 1e9
            for k, v in attrs.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self.phases[f"{name}_{k}"] = v
        emit(
            f"phase:{name}", self.last_ns, t,
            node=self.node, tid=self.tid,
            trace_id=self.trace_id, parent_id=self.parent_id,
            **attrs,
        )
        self.last_ns = t

    def restart(self) -> None:
        if self.on:
            self.last_ns = now_ns()


def add_phase_times(total: Optional[Dict[str, float]], parts) -> None:
    """Sum per-cohort phase dicts into the caller's (the JAX engines'
    rule for cohorted runs); no-op when the caller asked for none."""
    if total is None:
        return
    for d in parts:
        for name, v in (d or {}).items():
            total[name] = total.get(name, 0.0) + v


def phase_share(spans: List[dict]) -> Dict[str, float]:
    """Fold phase spans back into a phase table: span ``phase:<name>`` ->
    ``{name: seconds}`` and pipeline host stages ``host:<name>`` ->
    ``{host_<name>: seconds}``, summed over cohorts, with numeric span
    attrs flattened as ``<name>_<attr>`` (the OT host/device split).

    A run that produced no phase spans returns the explicit
    ``{"no_spans": 0.0}`` marker instead of an empty dict, so a reader
    can tell "nothing measured" from "lost"."""
    out: Dict[str, float] = {}
    for s in spans:
        if s["name"].startswith("phase:"):
            name = s["name"][len("phase:"):]
        elif s["name"].startswith("host:"):
            name = "host_" + s["name"][len("host:"):]
        else:
            continue
        out[name] = out.get(name, 0.0) + (s["t1_ns"] - s["t0_ns"]) / 1e9
        for k, v in s.get("attrs", {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"{name}_{k}"] = v
    if not out:
        return {"no_spans": 0.0}
    return out


def device_idle_fraction(spans: List[dict]) -> float:
    """Fraction of the traced window in which NO ``phase:*`` span was
    open. The window runs from the first to the last edge over both
    device (``phase:*``) and pipeline host-stage (``host:*``) spans, so
    host time at the edges counts against the device; overlapping phase
    spans (counter-phase cohorts) are unioned, not summed. 0.0 when no
    phase span exists (nothing measured, nothing claimable).

    A phase span is host time too (the engine enqueues, then syncs at
    the mark), so this is the share of the window outside every phase,
    not the card's idle share: ``perf.profile.fold_device_ops`` gives
    the device seconds inside each phase."""
    dev: List[tuple] = []
    lo = hi = None
    for s in spans:
        name = s.get("name", "")
        if not (name.startswith("phase:") or name.startswith("host:")):
            continue
        t0, t1 = s["t0_ns"], s["t1_ns"]
        lo = t0 if lo is None else min(lo, t0)
        hi = t1 if hi is None else max(hi, t1)
        if name.startswith("phase:"):
            dev.append((t0, t1))
    if not dev or hi is None or hi <= lo:
        return 0.0
    dev.sort()
    busy = 0
    cur0, cur1 = dev[0]
    for t0, t1 in dev[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    return max(0.0, 1.0 - busy / (hi - lo))
