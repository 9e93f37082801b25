#!/usr/bin/env python3
"""Where the PyTorch port's batched EdDSA sign spends its time on one GPU.

    python3 scripts/torch_eddsa_profile.py [--batch 4096] [--cohorts 2] [--seed 1]

Dealer keygen for B wallets (2-of-3 Ed25519), a first sign, then three
warm signs of B 32-byte messages: one timed by the host clock alone
(``sign_s``), one with the engine's phase timer (``phases_s``, which
synchronizes the device at each phase boundary), and one under
``torch.profiler`` with CPU and CUDA activity. From the profile: the
device events (kernels, copies, fills) and their summed device time,
the device's busy share of the profiled sign's wall time (kernels and copies on one
stream do not overlap each other), and the kernels that took most
device time. Every signature of the timed sign is checked with device
verification (the ok mask). Prints one JSON line, then the card's name
and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--cohorts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.utils.rng import SeededStream

    if not torch.cuda.is_available():
        print("torch_eddsa_profile: no CUDA device", file=sys.stderr)
        return 2
    B = args.batch
    shares = eb.dealer_keygen_batch(B, ["node0", "node1", "node2"], 1,
                                    rng=SeededStream(args.seed))
    signer = eb.BatchedCoSigners(["node0", "node1"], shares[:2],
                                 rng=SeededStream(args.seed + 1), device="cuda")
    mrng = np.random.default_rng(args.seed + 2)

    def msgs():
        return [r.tobytes() for r in mrng.integers(0, 256, (B, 32), dtype=np.uint8)]

    def sign(**kw):
        t0 = time.perf_counter()
        sigs, ok = signer.sign(msgs(), cohorts=args.cohorts, **kw)
        torch.cuda.synchronize()
        if not ok.all():
            raise AssertionError(f"ok={int(ok.sum())}/{B}")
        return time.perf_counter() - t0

    first_s = sign()
    sign_s = sign()
    phases: dict = {}
    phased_s = sign(phase_times=phases)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = sign()
    # device-side events: kernels and memory copies / sets
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "B": B, "cohorts": args.cohorts, "device": torch.cuda.get_device_name(0),
        "first_sign_s": first_s, "sign_s": sign_s, "sigs_per_s": B / sign_s,
        "phased_sign_s": phased_s, "phases_s": phases, "profiled_sign_s": profiled_s,
        "device_events": len(kernels),
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / profiled_s if kernels else None,
        "top_kernels": [{"name": n[:80], "launches": c, "device_s": t / 1e6}
                        for n, (c, t) in top],
    }), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
