"""mpctrace for the port: the span model of the JAX package's
``utils/tracing.py`` (the port's copy), plus the engines' phase timer.

Span identity is ``trace_id`` / ``span_id`` / ``parent_id``; clocks are
``time.monotonic_ns`` so spans from every node of an in-process cluster
share one timebase. Attributes are public metadata only: names that hit
the secret taxonomy (``analysis/taxonomy.py``) are refused.

Disabled (the default), :func:`span` returns a shared inert singleton
and :func:`emit`, :func:`instant` and :func:`incident` return at once,
so an untraced run does exactly the same work. :func:`enable` installs
a sink that receives each finished span as a dict ``{name, trace_id,
span_id, parent_id, node, tid, t0_ns, t1_ns, kind, attrs}``. The
incident hook (:func:`set_incident_hook`) is where a flight recorder
would attach; the port installs none yet. Ids come from a process-local
counter and a keyed hash of public names (:func:`trace_id_for`), so a
traced run makes the same decisions as an untraced one.

:func:`span_sync` and :class:`PhaseTimer` are the port's own: inside a
span they synchronize the device so the span is honest device time,
only while tracing (or the timer) is on.
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


def _is_secret_attr(name: str) -> bool:
    # lazy import, as in the JAX package: tracing imports nothing of the
    # project at load time, so every layer can depend on it
    from ..analysis.taxonomy import is_secret_name

    return is_secret_name(name)


def clean_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Attribute hygiene: secret-taxonomy names are refused (value
    replaced with a marker, the value itself never retained); non-scalar
    values are reduced to their type name so no object repr can smuggle
    key material into a trace."""
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if _is_secret_attr(k):
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


def span_sync(device: torch.device) -> None:
    """Finish the device work queued inside a span before it closes, so
    the span is honest device time — only while tracing is on."""
    if _ENABLED and device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    __slots__ = ("on", "phases", "device", "last")

    def __init__(self, device: torch.device,
                 phase_times: Optional[Dict[str, float]] = None) -> None:
        self.on = phase_times is not None
        self.phases = phase_times
        self.device = device
        self.last = time.perf_counter() if self.on else 0.0

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + (t - self.last)
        self.last = t

    def restart(self) -> None:
        """Start the next phase now: a cohort calls this when it resumes,
        so time spent on other cohorts' rounds counts in none of its
        phases."""
        if self.on:
            self.last = time.perf_counter()
