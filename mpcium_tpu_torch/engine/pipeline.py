"""Counter-phase cohort pipeline (the port's copy of
``mpcium_tpu/engine/pipeline.py``).

A batch of B sessions splits into K **cohorts** — contiguous,
equal-width lane ranges (``MPCIUM_PIPELINE_COHORTS``, default 2; K=1 is
the serial path and the transcript oracle). Each cohort's round schedule
is a generator that *yields* its host stages as ``(label, thunk)``;
:func:`run_counter_phase` drives the K generators round-robin on the
main thread with ONE background host worker, so while one cohort's host
stage (signature egress) drains, the next cohort's device rounds are
queued (PyTorch on a GPU does not block until a value is read).

Transcript discipline: callers draw ALL secret randomness for the full
batch in K=1 serial order *before* splitting, then row-slice per cohort,
so signatures are bit-identical for every K. Cohort widths stay on the
pow-2 bucket grid; :func:`resolve_cohorts` falls back to K=1 whenever a
split would leave it.

Pure stdlib (plus torch/numpy in :func:`merge_rows`).
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Generator, List, Optional, Sequence, Tuple

from .abort import CohortAbort
from .buckets import is_bucket

ENV_COHORTS = "MPCIUM_PIPELINE_COHORTS"
DEFAULT_COHORTS = 2
# below this many lanes per cohort the split costs more than it overlaps
MIN_COHORT_LANES = 2

# One background worker, shared process-wide (the mta_ot _HOST_POOL
# pattern): host stages of different cohorts serialize against each
# other — they contend for the GIL and wire anyway — while the main
# thread keeps dispatching device rounds.
_HOST_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _host_pool() -> ThreadPoolExecutor:
    global _HOST_POOL
    with _POOL_LOCK:
        if _HOST_POOL is None:
            _HOST_POOL = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pipe-host"
            )
    return _HOST_POOL


def resolve_cohorts(B: int, cohorts: Optional[int] = None) -> int:
    """The cohort count a batch of B sessions actually runs with.

    Explicit ``cohorts`` wins, then ``MPCIUM_PIPELINE_COHORTS``, then
    the default (2). The result is clamped onto the bucket grid: K must
    be a power of two dividing B with at least MIN_COHORT_LANES lanes
    per cohort — otherwise K halves until it fits (worst case K=1, the
    serial oracle). A pow-2 B therefore always yields pow-2 cohort
    widths, so cohort dispatches reuse the prewarmed bucket compiles.
    """
    if B < 1:
        raise ValueError(f"need B >= 1, got {B}")
    if cohorts is None:
        raw = os.environ.get(ENV_COHORTS, "")
        try:
            cohorts = int(raw) if raw else DEFAULT_COHORTS
        except ValueError:
            cohorts = DEFAULT_COHORTS
    k = max(1, int(cohorts))
    # floor to a power of two
    while k & (k - 1):
        k &= k - 1
    while k > 1 and (
        B % k != 0
        or (B // k) < MIN_COHORT_LANES
        or not is_bucket(B // k)
    ):
        k //= 2
    return k


class CohortPlan:
    """The lane geometry of one cohorted batch: K contiguous equal
    slices of range(B), plus the lane maps that keep identifiable abort
    (engine.abort.CohortAbort) attributable through the split."""

    def __init__(self, B: int, k: int):
        if k < 1 or B % k != 0:
            raise ValueError(f"invalid cohort plan B={B} k={k}")
        self.B = B
        self.k = k
        self.width = B // k
        self.bounds: List[Tuple[int, int]] = [
            (i * self.width, (i + 1) * self.width) for i in range(k)
        ]

    @classmethod
    def for_batch(cls, B: int, cohorts: Optional[int] = None) -> "CohortPlan":
        return cls(B, resolve_cohorts(B, cohorts))

    @property
    def serial(self) -> bool:
        return self.k == 1

    def slices(self) -> List[slice]:
        return [slice(lo, hi) for lo, hi in self.bounds]

    def split(self, arr: Any, axis: int = 0) -> List[Any]:
        """Row-slice any indexable array-like into the K cohort views
        along ``axis`` (views, not copies, for numpy arrays and tensors)."""
        idx_head: Tuple = (slice(None),) * axis
        return [arr[idx_head + (sl,)] for sl in self.slices()]

    def split_tree(self, tree: Any, axis: int = 0) -> List[Any]:
        """Like :meth:`split` over a nested dict/list/tuple of arrays:
        returns K trees of the same structure with every leaf sliced."""
        if isinstance(tree, dict):
            parts = {k: self.split_tree(v, axis) for k, v in tree.items()}
            return [
                {k: v[i] for k, v in parts.items()} for i in range(self.k)
            ]
        if isinstance(tree, (list, tuple)):
            parts = [self.split_tree(v, axis) for v in tree]
            if hasattr(tree, "_fields"):  # NamedTuple (point tuples)
                return [
                    type(tree)(*(p[i] for p in parts))
                    for i in range(self.k)
                ]
            return [
                type(tree)(p[i] for p in parts) for i in range(self.k)
            ]
        return self.split(tree, axis)

    def to_global(self, cohort: int, lane: int) -> int:
        """Cohort-local lane index → batch-global lane index."""
        lo, hi = self.bounds[cohort]
        if not 0 <= lane < hi - lo:
            raise ValueError(f"lane {lane} outside cohort {cohort}")
        return lo + lane

    def remap_abort(self, err: CohortAbort, cohort: int) -> CohortAbort:
        """A CohortAbort raised with cohort-LOCAL lane indices, remapped
        to batch-global lanes — blame attribution (party, check) rides
        through unchanged, so the scheduler's quarantine path
        names the same culprit at every K."""
        return CohortAbort(
            [
                (self.to_global(cohort, lane), party, check)
                for lane, party, check in err.culprits
            ],
            engine=err.engine,
        )


# One cohort's schedule: a generator yielding (label, host_thunk) and
# returning its result via StopIteration.value.
CohortJob = Callable[[], Generator[Tuple[str, Callable[[], Any]], Any, Any]]


def _run_host_stage(label: str, thunk: Callable[[], Any], cohort: int) -> Any:
    """Execute one host stage (``label``/``cohort`` name it for readers)."""
    return thunk()


def run_counter_phase(jobs: Sequence[CohortJob]) -> List[Any]:
    """Drive K cohort jobs in counter-phase; returns their results in
    cohort order.

    K=1 (or a single job) runs fully inline on the calling thread —
    byte-for-byte today's serial path, the transcript oracle. K>1
    round-robins the generators: each advance runs the cohort's device
    dispatches (async) up to its next host stage, which is shipped to
    the shared host worker; while that drains, the next cohort advances.
    Exceptions propagate to the caller unchanged (wrap CohortAborts with
    :meth:`CohortPlan.remap_abort` inside the job before raising).
    """
    gens = [job() for job in jobs]
    n = len(gens)
    results: List[Any] = [None] * n

    if n == 1:
        g = gens[0]
        try:
            req = next(g)
            while True:
                label, thunk = req
                req = g.send(_run_host_stage(label, thunk, 0))
        except StopIteration as fin:
            results[0] = fin.value
        return results

    pool = _host_pool()
    pending: List[Any] = [None] * n
    done = [False] * n
    remaining = n
    while remaining:
        for i, g in enumerate(gens):
            if done[i]:
                continue
            try:
                if pending[i] is None:
                    req = next(g)
                else:
                    fut, pending[i] = pending[i], None
                    req = g.send(fut.result())
                label, thunk = req
                pending[i] = pool.submit(_run_host_stage, label, thunk, i)
            except StopIteration as fin:
                results[i] = fin.value
                done[i] = True
                remaining -= 1
    return results


def merge_rows(parts: Sequence[Any], axis: int = 0):
    """Concatenate per-cohort result rows back into batch order: torch
    tensors with ``torch.cat``, host arrays with ``np.concatenate``."""
    import numpy as np
    import torch

    if len(parts) == 1:
        return parts[0]
    if all(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat(list(parts), dim=axis)
    return np.concatenate([np.asarray(p) for p in parts], axis=axis)
