"""In-process protocol runner: runs a set of parties to completion (the
port's copy of ``mpcium_tpu/protocol/runner.py``).

Messages route synchronously — broadcast fan-out and unicast — until
every party reports done. Production routing goes over a transport; this
runner pins protocol correctness independent of it.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List

from ..utils import tracing
from .base import PartyBase


def run_protocol(parties: Dict[str, PartyBase], max_msgs: int = 100_000) -> None:
    """Drive all parties until done. Raises on protocol errors and stalls."""
    queue: deque = deque()
    # one shared trace id for the whole run; spans exist only when
    # tracing is on, and the message flow is identical either way
    run_tid = tracing.trace_id_for("runner:" + "|".join(sorted(parties)))
    # sorted: every member walks the peer set in the same order
    for _pid, party in sorted(parties.items()):
        with tracing.span("round:start", trace_id=run_tid, node=_pid, tid="runner"):
            for m in party.start():
                queue.append(m)
    delivered = 0
    while queue:
        msg = queue.popleft()
        delivered += 1
        if delivered > max_msgs:
            raise RuntimeError("protocol did not converge (message storm)")
        targets: List[PartyBase] = (
            [p for pid, p in sorted(parties.items()) if pid != msg.from_id]
            if msg.is_broadcast
            else [parties[msg.to]]
        )
        for t in targets:
            with tracing.span(f"round:{msg.round}", trace_id=run_tid,
                              node=t.self_id, tid="runner", sender=msg.from_id):
                for out in t.receive(msg):
                    queue.append(out)
    stalled = [pid for pid, p in sorted(parties.items()) if not p.done]
    if stalled:
        raise RuntimeError(f"protocol stalled; undone parties: {stalled}")
