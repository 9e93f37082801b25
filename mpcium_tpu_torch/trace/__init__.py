"""mpctrace: flight recorder + Perfetto export over utils.tracing.

``arm()`` turns tracing on with the per-node flight recorders as the
sink — the always-on mode every cluster/daemon runs in. The engine
flagship path never arms, so the bench number rides the no-op gate.
See OBSERVABILITY.md for the span model and how-to.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..utils import tracing
from . import recorder
from .export import chrome_trace
from .schema import TraceSchemaError, validate_chrome

__all__ = [
    "arm", "disarm", "armed", "snapshot_chrome",
    "chrome_trace", "validate_chrome", "TraceSchemaError", "recorder",
]


def arm(
    node_ids: Optional[List[str]] = None,
    capacity: Optional[int] = None,
    dump_dir: Optional[str] = None,
) -> None:
    """Enable tracing with flight recorders as the sink. Resets the
    buffers of ``node_ids`` (so reused node names start clean) and
    optionally configures the incident dump directory."""
    if node_ids is not None or capacity is not None:
        recorder.reset(node_ids, capacity=capacity)
    recorder.set_dump_dir(dump_dir)
    tracing.enable(sink=recorder.record)
    tracing.set_incident_hook(recorder.dump_incident)


def disarm() -> None:
    tracing.disable()
    recorder.set_dump_dir(None)


def armed() -> bool:
    return tracing.enabled()


def snapshot_chrome(
    node_ids: Optional[List[str]] = None,
    clear: bool = False,
    meta: Optional[Dict[str, object]] = None,
) -> dict:
    """Merge per-node flight recorders into one Chrome-trace document
    (pid=node, tid=session/lane) — the payload LocalCluster, drills and
    soak reports embed."""
    return chrome_trace(recorder.snapshot_all(node_ids, clear=clear), meta=meta)
