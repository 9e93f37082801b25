"""Identifiable-abort vocabulary shared by the batched engines and the
scheduler (the port's copy of ``mpcium_tpu/engine/abort.py``).

A batched cohort fails *attributably*: when a protocol check (OT-MtA
KOS correlation, Gilboa encoding, MtA output consistency — see
protocol.ecdsa.mta_ot) catches deviation, the engine raises
:class:`CohortAbort` naming every (lane, party, check) it can blame
instead of silently zeroing the lane's ok bit. The scheduler catches it,
quarantines exactly the culprit sessions (retryable, culprit-named ABORT
events) and re-packs the survivors onto the next bucket
(consumers.batch_scheduler._absorb_cohort_abort) — one cheater never
poisons a 4096-session batch.

Pure stdlib on purpose.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

Culprit = Tuple[int, str, str]  # (batch lane, party id, check name)


class CohortAbort(RuntimeError):
    """An attributable check failed inside a batched cohort.

    ``culprits`` lists every blamed (lane, party_id, check_name); a lane
    appears at most once (the engine keeps the first — most upstream —
    check that caught it). Lanes not listed are honest-so-far survivors:
    their inputs were consumed by the aborted batch, so the caller must
    re-run them (the scheduler re-packs them bucket-snapped).
    """

    def __init__(self, culprits: Sequence[Culprit], engine: str = "gg18.sign"):
        self.culprits: List[Culprit] = [
            (int(lane), str(pid), str(check)) for lane, pid, check in culprits
        ]
        self.engine = engine
        detail = "; ".join(
            f"lane {lane}: party {pid} failed check '{check}'"
            for lane, pid, check in self.culprits
        )
        super().__init__(f"cohort abort ({engine}): {detail}")

    def lanes(self) -> List[int]:
        """Sorted culprit lane indices."""
        return sorted({lane for lane, _pid, _check in self.culprits})
