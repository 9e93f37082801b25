"""Per-node flight recorders: bounded ring buffers of finished spans.

Always on once armed, never unbounded: each node keeps the most recent
``capacity`` spans (default 4096 ≈ a few minutes of soak traffic) and an
exact dropped-span counter, so a post-mortem knows both what happened
recently and how much history scrolled off. Recorders are keyed by node
id in a module-level registry because a LocalCluster runs all nodes in
one process; ``trace.arm()`` installs ``record`` as the
tracing sink and routes each span to its node's buffer.

Incident dumps: when configured with ``set_dump_dir``, an incident
(shed/timeout/drill failure) writes the merged Chrome-trace JSON to
``trace_incident_<kind>_<n>.json`` — capped at ``_DUMP_LIMIT`` files per
process so a shed storm cannot fill a disk.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

DEFAULT_CAPACITY = 4096
_DUMP_LIMIT = 8


class FlightRecorder:
    """Bounded ring buffer of span dicts with an exact dropped count."""

    def __init__(self, node_id: str, capacity: int = DEFAULT_CAPACITY) -> None:
        self.node_id = node_id
        self.capacity = capacity
        self._lock = threading.Lock()
        self._spans: Deque[dict] = deque(maxlen=capacity)
        self.dropped = 0

    def record(self, span: dict) -> None:
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)

    def snapshot(self, clear: bool = False) -> Tuple[List[dict], int]:
        with self._lock:
            spans = list(self._spans)
            dropped = self.dropped
            if clear:
                self._spans.clear()
                self.dropped = 0
        return spans, dropped


_lock = threading.Lock()
_recorders: Dict[str, FlightRecorder] = {}
_capacity = DEFAULT_CAPACITY
_dump_dir: Optional[str] = None
_dump_count = 0


def recorder_for(node_id: str) -> FlightRecorder:
    with _lock:
        rec = _recorders.get(node_id)
        if rec is None:
            rec = FlightRecorder(node_id, _capacity)
            _recorders[node_id] = rec
        return rec


def record(span: dict) -> None:
    """The tracing sink: route a finished span to its node's buffer."""
    recorder_for(span.get("node") or "local").record(span)


def reset(node_ids: Optional[List[str]] = None, capacity: Optional[int] = None) -> None:
    """Drop buffers (all, or just the named nodes). A new LocalCluster
    resets its node ids so traces never bleed between test clusters that
    reuse node names."""
    global _capacity
    with _lock:
        if capacity is not None:
            _capacity = capacity
        if node_ids is None:
            _recorders.clear()
        else:
            for nid in node_ids:
                _recorders.pop(nid, None)


def snapshot_all(
    node_ids: Optional[List[str]] = None, clear: bool = False
) -> Dict[str, Tuple[List[dict], int]]:
    """Per-node (spans, dropped) for the requested nodes (default all)."""
    with _lock:
        items = [
            (nid, rec) for nid, rec in sorted(_recorders.items())
            if node_ids is None or nid in node_ids
        ]
    return {nid: rec.snapshot(clear=clear) for nid, rec in items}


def set_dump_dir(path: Optional[str]) -> None:
    global _dump_dir, _dump_count
    _dump_dir = path
    _dump_count = 0


def dump_incident(kind: str, node: str, attrs: dict) -> None:
    """Incident hook target: write the merged buffers to the configured
    dump dir (bounded count). Never raises — a failed dump must not
    take the serving path down with it."""
    global _dump_count
    if _dump_dir is None:
        return
    with _lock:
        if _dump_count >= _DUMP_LIMIT:
            return
        _dump_count += 1
        n = _dump_count
    from .export import chrome_trace

    try:
        snap = snapshot_all()
        doc = chrome_trace(
            snap,
            meta={"incident": kind, "node": node, "attrs": attrs},
        )
        os.makedirs(_dump_dir, exist_ok=True)
        fn = os.path.join(_dump_dir, f"trace_incident_{kind}_{n}.json")
        with open(fn, "w") as fh:
            json.dump(doc, fh)
        from ..utils import log

        # the summary line an operator greps before opening the JSON:
        # how much history the dump holds and how much scrolled off
        log.info(
            "trace incident dumped", kind=kind, node=node, file=fn,
            spans=sum(len(s) for s, _d in snap.values()),
            ring_dropped={nid: d for nid, (_s, d) in sorted(snap.items())
                          if d},
        )
    except OSError:
        from ..utils import log

        log.warn("trace incident dump failed", kind=kind, dir=_dump_dir)
