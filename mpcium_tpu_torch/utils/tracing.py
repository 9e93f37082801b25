"""Phase timing for the engines, and the span surface of the protocol
layer.

:class:`PhaseTimer` closes one wall-clock interval per protocol phase.
It is off unless the caller passes a ``phase_times`` dict; when on, each
``mark`` synchronizes the device first (``torch.cuda.synchronize``), so
a phase's seconds include the device work queued during it. Off, a mark
is one attribute load — no sync, nothing recorded.

:func:`span` is the port's copy of the JAX package's mpctrace span
surface (``mpcium_tpu/utils/tracing.py``), as far as the batched parties
and the in-process runner use it: disabled (the default) it returns a
shared inert context manager, so an untraced run does exactly the same
work; :func:`enable` installs a sink that receives each finished span
as a dict ``{name, trace_id, node, tid, t0_ns, t1_ns, attrs}``. Ids
come from a keyed hash of public names (:func:`trace_id_for`), so a
traced run makes the same decisions as an untraced one.
"""
from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Dict, Optional

import torch

_ENABLED = False
_sink: Optional[Callable[[dict], None]] = None


def enabled() -> bool:
    return _ENABLED


def enable(sink: Optional[Callable[[dict], None]] = None) -> None:
    """Turn span recording on; ``sink`` gets each finished span dict."""
    global _ENABLED, _sink
    _ENABLED, _sink = True, sink


def disable() -> None:
    global _ENABLED, _sink
    _ENABLED, _sink = False, None


def trace_id_for(name: str) -> str:
    """Deterministic trace id from a public name (session id, run name):
    every node derives the same id for the same session."""
    return hashlib.sha256(b"mpctrace|" + name.encode()).hexdigest()[:16]


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, trace_id: Optional[str], node: str, tid: str,
                 attrs: Dict[str, Any]) -> None:
        self.rec = {"name": name, "trace_id": trace_id or trace_id_for(name),
                    "node": node, "tid": tid, "t0_ns": 0, "t1_ns": 0, "attrs": attrs}

    def __enter__(self) -> "_Span":
        self.rec["t0_ns"] = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.rec["t1_ns"] = time.monotonic_ns()
        if exc_type is not None:
            self.rec["attrs"]["error"] = exc_type.__name__
        if _sink is not None:
            _sink(self.rec)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NOOP_SPAN = _NoopSpan()


def span(name: str, *, trace_id: Optional[str] = None, node: str = "local",
         tid: str = "main", **attrs: Any):
    """A span as a context manager; keywords other than ``trace_id``,
    ``node`` and ``tid`` become its attributes. The shared no-op span
    while tracing is off."""
    if not _ENABLED:
        return NOOP_SPAN
    return _Span(name, trace_id, node, tid, attrs)


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
