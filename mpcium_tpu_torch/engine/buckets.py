"""Canonical pow-2 shape buckets for the batch/session dimension.

The port's copy of ``mpcium_tpu/engine/buckets.py``: the allowed
batch sizes B. The cohort pipeline keeps cohort widths on this grid.

Pure stdlib on purpose.
"""
from __future__ import annotations

BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
           16384)

_BUCKET_SET = frozenset(BUCKETS)


def is_bucket(n: int) -> bool:
    return n in _BUCKET_SET


def floor_bucket(n: int) -> int:
    """Largest bucket <= n — the chunk size a scheduler drain uses so a
    manifest (hence the engine batch dim) is always a bucket."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    best = BUCKETS[0]
    for b in BUCKETS:
        if b > n:
            break
        best = b
    return best


def bucket_b(n: int) -> int:
    """Smallest bucket >= n (clamped to the largest bucket) — the
    pad-up form bench sweeps and pre-warming use."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    for b in BUCKETS:
        if b >= n:
            return b
    return BUCKETS[-1]
