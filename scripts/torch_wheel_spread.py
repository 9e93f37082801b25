#!/usr/bin/env python
"""The ``wheel_latency`` micro-bench row's spread, by hops a sample, on an
idle and on a loaded host.

``chip_smoke.py`` phase 32 requires ``statcheck.gate`` to flag a copy of
each micro-bench row scaled by 1.5. That verdict holds only while a row's
samples spread little; ``wheel_latency`` (one schedule→fire hop of the
scheduler's timing wheel, two thread wake-ups) spreads most where the
host's cores are busy. This script measures the row with 3 hops a sample
(the row's earlier setting) and with ``microbench.WHEEL_HOPS``, first on
the idle host, then beside ``--busy`` spinning processes (default: one per
core, as the lanes of ``chip_smoke.py`` load the card's host), and prints
for each: median and p90 ms, max over min, p90 over median, and the gate's
two verdicts (the row against itself, against its 1.5× copy). Host code
only: it needs no GPU.

Usage: python scripts/torch_wheel_spread.py [--samples 30] [--repeats 3] [--busy N]
       [--hops 3,64]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpcium_tpu_torch.perf import microbench, statcheck  # noqa: E402


def _spin(stop) -> None:
    x = 0
    while not stop.is_set():
        for _ in range(10_000):
            x = (x * 1103515245 + 12345) & 0xFFFFFFFF


def _row(xs: list) -> dict:
    s = sorted(xs)
    med = statcheck.median(s)
    p90 = s[int(0.9 * (len(s) - 1))]
    same = statcheck.gate({"w": xs}, {"w": xs})
    slow = statcheck.gate({"w": xs}, {"w": [x * 1.5 for x in xs]})
    return {"median_ms": med * 1e3, "p90_ms": p90 * 1e3, "max_over_min": s[-1] / s[0],
            "p90_over_median": p90 / med, "self_ok": same.ok, "scaled_flagged": not slow.ok}


def measure(samples: int, repeats: int, hop_counts) -> dict:
    return {f"hops_{h}": [_row(microbench.wheel_latency(samples, hops=h)) for _ in range(repeats)]
            for h in hop_counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=microbench.DEFAULT_SAMPLES)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--busy", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--hops", default=f"3,{microbench.WHEEL_HOPS}",
                    help="comma list of hops a sample to measure")
    args = ap.parse_args(argv)
    hop_counts = sorted({int(h) for h in args.hops.split(",") if h.strip()})
    out = {"samples": args.samples, "cores": os.cpu_count(), "busy": args.busy,
           "idle": measure(args.samples, args.repeats, hop_counts)}
    ctx = mp.get_context("spawn")
    stop = ctx.Event()
    procs = [ctx.Process(target=_spin, args=(stop,), daemon=True) for _ in range(args.busy)]
    for p in procs:
        p.start()
    try:
        out["loaded"] = measure(args.samples, args.repeats, hop_counts)
    finally:
        stop.set()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
