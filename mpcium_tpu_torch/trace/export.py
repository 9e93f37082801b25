"""Chrome-trace-event export: merge per-node span buffers into one JSON
document loadable in Perfetto / chrome://tracing.

Mapping: pid = node (one process row per node), tid = the span's track
(session id or scheduler lane). Both get human names via ``M`` metadata
events so Perfetto shows ``node0`` / ``lane:interactive`` instead of
bare integers. Timestamps are microseconds relative to the earliest
span in the document (monotonic clocks share a timebase in-process, so
cross-node alignment is exact for LocalCluster traces).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

TRACE_FORMAT = "chrome-trace-events"


def chrome_trace(
    per_node: Dict[str, Tuple[List[dict], int]],
    meta: Optional[dict] = None,
    extra_events: Optional[List[dict]] = None,
) -> dict:
    """Build the Chrome trace document from ``{node: (spans, dropped)}``
    (the shape ``recorder.snapshot_all`` returns). ``extra_events`` are
    pre-built Chrome events appended verbatim — the perf ledger's
    counter track (``perf.report.counter_track``) rides in here so the
    bench trajectory lands in the same Perfetto document."""
    events: List[dict] = []
    pid_of: Dict[str, int] = {}
    tid_of: Dict[Tuple[str, str], int] = {}
    all_spans: List[Tuple[str, dict]] = [
        (node, s) for node, (spans, _d) in sorted(per_node.items())
        for s in spans
    ]
    t_base = min((s["t0_ns"] for _n, s in all_spans), default=0)

    for node, (_spans, _dropped) in sorted(per_node.items()):
        pid_of[node] = len(pid_of) + 1
        events.append({
            "ph": "M", "name": "process_name", "pid": pid_of[node], "tid": 0,
            "args": {"name": node},
        })

    for node, s in all_spans:
        pid = pid_of[node]
        track = str(s.get("tid") or "main")
        key = (node, track)
        if key not in tid_of:
            tid_of[key] = len([k for k in tid_of if k[0] == node]) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tid_of[key], "args": {"name": track},
            })
        tid = tid_of[key]
        ts_us = (s["t0_ns"] - t_base) / 1e3
        args = dict(s.get("attrs") or {})
        args["trace_id"] = s["trace_id"]
        args["span_id"] = s["span_id"]
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        if s.get("kind") == "i":
            events.append({
                "ph": "i", "name": s["name"], "pid": pid, "tid": tid,
                "ts": ts_us, "s": "t", "args": args,
            })
        else:
            events.append({
                "ph": "X", "name": s["name"], "pid": pid, "tid": tid,
                "ts": ts_us, "dur": max(0.0, (s["t1_ns"] - s["t0_ns"]) / 1e3),
                "args": args,
            })

    if extra_events:
        events.extend(extra_events)

    other = {
        "format": TRACE_FORMAT,
        "dropped_spans": {
            node: d for node, (_s, d) in sorted(per_node.items())
        },
    }
    if meta:
        other.update(meta)
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": other}
