#!/usr/bin/env python3
"""Count the tensor ops of one batched EdDSA sign, per protocol phase.

    python3 scripts/torch_eddsa_opcount.py [--batch 8] [--cohorts 2] [--device cpu]

Eager PyTorch launches one kernel per op, so the count of non-view ops a
sign dispatches is what a launch-bound sign pays for, and it does not
depend on B (only on the cohort count, since each cohort runs every
round). A ``TorchDispatchMode`` counts every aten op below autograd
except views and metadata ops, one warm sign of 2-of-3 Ed25519 over B
seeded 32-byte messages, split at the engine's phase marks. Prints one
JSON line: ops per phase, their sum, and the most frequent ops. Runs on
the CPU by default (a count, not a time); imports nothing of JAX.

With ``--device cuda`` the engine's graphed functions (``engine/graphs``)
replay CUDA graphs captured in the first (warm) sign: a replay is one
launch and no aten op, so the count is what the sign still dispatches
from Python (input copies, output clones, the glue between rounds);
``graph_replays`` counts the replays of the counted sign.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

_VIEWS = {
    "view", "_unsafe_view", "expand", "unsqueeze", "squeeze", "slice", "select",
    "unbind", "t", "transpose", "permute", "alias", "detach", "reshape",
    "as_strided", "split", "_reshape_alias", "lift_fresh",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cohorts", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np
    from torch.utils._python_dispatch import TorchDispatchMode

    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.engine import graphs
    from mpcium_tpu_torch.utils import tracing
    from mpcium_tpu_torch.utils.rng import SeededStream

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n, self.by = 0, Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if name not in _VIEWS:
                self.n += 1
                self.by[name] += 1
            return func(*args, **(kwargs or {}))

    B = args.batch
    shares = eb.dealer_keygen_batch(B, ["node0", "node1", "node2"], 1, rng=SeededStream(1))
    signer = eb.BatchedCoSigners(["node0", "node1"], shares[:2], rng=SeededStream(2),
                                 device=args.device)
    msgs = [r.tobytes() for r in np.random.default_rng(3).integers(0, 256, (B, 32), np.uint8)]
    signer.sign(msgs, cohorts=args.cohorts)  # warm: tables and caches built

    counter, per_phase = Count(), Counter()

    def mark(self, name: str, *tensors, **attrs) -> None:  # counting instead of timing
        per_phase[name] += counter.n
        counter.n = 0

    graphs.reset_counts()
    tracing.PhaseTimer.mark, original = mark, tracing.PhaseTimer.mark
    try:
        with counter:
            signer.sign(msgs, cohorts=args.cohorts, phase_times={})
    finally:
        tracing.PhaseTimer.mark = original
    print(json.dumps({
        "B": B, "cohorts": args.cohorts, "device": args.device,
        "ops_by_phase": dict(per_phase), "ops": sum(per_phase.values()),
        "top_ops": counter.by.most_common(12),
        "graph_replays": sum(c["replays"] for c in graphs.counts().values()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
