#!/usr/bin/env python
"""Chaos drill CLI for the PyTorch port: run named fault-injection drills
against an in-process cluster on a device and print their structured
reports as JSON.

    python scripts/torch_chaos_drill.py --device cpu               # the catalog
    python scripts/torch_chaos_drill.py --device cpu --drill partition
    python scripts/torch_chaos_drill.py --drill kill-resume        # on the GPU
    python scripts/torch_chaos_drill.py --seed 42 --drill drop-jitter --device cpu
    python scripts/torch_chaos_drill.py --list

``--device`` defaults to the GPU (``cuda``); a missing GPU lands in each
report as the drill's error. Reproducibility: the report embeds the seed
and the full fault-plan JSON; rerunning with the same ``--seed --drill``
reproduces the identical fault schedule (mpcium_tpu_torch/faults/plan.py).
Each report's trace document is printed by its event count
(``--trace`` prints it whole). Exit status is non-zero when any drill
misses its expected outcome.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    from mpcium_tpu_torch.faults.chaos import DEFAULT_SEED, DRILLS, run_drill
    from mpcium_tpu_torch.utils import log

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED,
                    help=f"fault-schedule seed (default {DEFAULT_SEED})")
    ap.add_argument("--drill", "--plan", dest="drill", default="all",
                    help="drill name, or 'all' (default)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="time-constant scale for jitter windows "
                    "(probabilities never change; default 1.0)")
    ap.add_argument("--device", default=None,
                    help="torch device of the drill clusters (default: the GPU)")
    ap.add_argument("--list", action="store_true", help="list drills")
    ap.add_argument("--trace", action="store_true",
                    help="print each report's trace document whole")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress cluster logs, print only reports")
    args = ap.parse_args()

    if args.list:
        for name, (_fn, expected) in DRILLS.items():
            print(f"{name:18s} expected: {expected}")
        return 0

    log.init(level="ERROR" if args.quiet else "INFO")
    names = list(DRILLS) if args.drill == "all" else [args.drill]
    reports = []
    for name in names:
        r = run_drill(name, seed=args.seed, scale=args.scale, device=args.device)
        reports.append(r)
        out = r.to_json()
        if not args.trace:
            out["trace"] = {"events": len(r.trace.get("traceEvents", []))}
        print(json.dumps(out, indent=2))
    failed = [r.name for r in reports if not r.ok]
    print(json.dumps({
        "seed": args.seed,
        "device": args.device or "cuda",
        "drills": len(reports),
        "passed": len(reports) - len(failed),
        "failed": failed,
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
