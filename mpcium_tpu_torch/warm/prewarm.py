"""``warm_for_drill``: the kill-resume chaos drill's warm pass.

The JAX package's ``warm/prewarm.py`` compiles and caches the serving
set's executables; its ``warm_for_drill`` warms one manifest entry
(EdDSA, bucket 2) so the drill's ``resume_latency_s`` measures recovery,
not a compile wall. The port compiles nothing per shape, so its
counterpart runs that bucket once — a B=2 batched EdDSA sign of two
dealer wallets on the given device, which pays the process's first-use
costs there (the allocator, the lazily built tables, the device
context) — and reports the same keys. The rest of the JAX ``warm/``
(manifests, the budgeted boot pass, the AOT store) is not ported.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Set, Tuple

from ..device import DeviceLike, resolve
from ..utils import log

DRILL_BUCKET = ("eddsa", 2)
_LOCK = threading.Lock()
_RAN: Set[Tuple[str, int, str]] = set()  # (scheme, bucket, device) run here


def _run_bucket(B: int, device) -> None:
    from ..engine import eddsa_batch as eb
    from ..utils.rng import DetRng

    ids = ["node0", "node1", "node2"]
    rng = DetRng(0)
    shares = eb.dealer_keygen_batch(B, ids, threshold=1, rng=rng)
    signer = eb.BatchedCoSigners(ids[:2], shares[:2], rng=rng, device=device)
    _sigs, ok = signer.sign([b"warm:%031d" % i for i in range(B)])
    if not bool(ok.all()):
        raise RuntimeError("warm sign produced an invalid signature")


def warm_for_drill(budget_s: float = 60.0,
                   device: DeviceLike = None) -> Dict[str, object]:
    """Run the drill's signing bucket (EdDSA, B=2) once on ``device``
    (None: the GPU) and report ``{warmed, hits, budget_s}``: ``warmed``
    the buckets ready afterwards, ``hits`` those this process had already
    run. Never raises: a failure (no GPU, a budget overrun) is logged and
    reported as nothing warmed."""
    try:
        dev = resolve(device)
        key = DRILL_BUCKET + (str(dev),)
        with _LOCK:
            hit = key in _RAN
        if not hit:
            t0 = time.monotonic()
            _run_bucket(DRILL_BUCKET[1], dev)
            wall = time.monotonic() - t0
            if wall > budget_s:
                log.warn("warm: drill bucket overran its budget",
                         wall_s=round(wall, 3), budget_s=budget_s)
            with _LOCK:
                _RAN.add(key)
        return {"warmed": 1, "hits": int(hit), "budget_s": budget_s}
    except Exception as exc:  # noqa: BLE001 — a drill must not die warming
        log.warn("warm: drill warm pass failed", error=repr(exc))
        return {"warmed": 0, "hits": 0, "budget_s": budget_s}
