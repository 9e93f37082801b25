#!/usr/bin/env python
"""Load-soak CLI for the PyTorch port: bursty mixed traffic against an
in-process cluster running the SLO scheduler on a device, with a chaos
fault plan active, and a JSON report of what the cluster served.

    python scripts/torch_load_soak.py --device cpu --signs 6     # a small soak
    python scripts/torch_load_soak.py --out GPU_SOAK_r01.json    # on the GPU
    python scripts/torch_load_soak.py --device cpu --chaos ""    # faults off

``--device`` defaults to the GPU (``cuda``) and raises where there is
none. ``--out`` names must match ``GPU_SOAK_*.json``: the JAX package's
perf ledger reads every ``SOAK_*.json`` at the root as its own record.
Exit status is non-zero when the accounting invariant fails — a request
that produced NO terminal outcome (success, retryable shed, or error) is
a silent drop, the one bug class this harness exists to catch.

Reproducibility: the report embeds the full config, the fault-plan seed
and rule set; rerunning with the same flags replays the same traffic
schedule and fault schedule.
"""
import argparse
import fnmatch
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT_GLOB = "GPU_SOAK_*.json"


def main() -> int:
    from mpcium_tpu_torch.soak import SoakConfig, run_soak, write_report
    from mpcium_tpu_torch.utils import log

    defaults = SoakConfig()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the cluster (default: the GPU)")
    ap.add_argument("--signs", type=int, default=defaults.n_sign)
    ap.add_argument("--keygens", type=int, default=defaults.n_keygen)
    ap.add_argument("--reshares", type=int, default=defaults.n_reshare)
    ap.add_argument("--wallets", type=int, default=defaults.n_wallets)
    ap.add_argument("--nodes", type=int, default=defaults.n_nodes)
    ap.add_argument("--threshold", type=int, default=defaults.threshold)
    ap.add_argument("--burst", type=int, default=defaults.burst_size)
    ap.add_argument("--burst-gap", type=float, default=defaults.burst_gap_s)
    ap.add_argument("--seed", type=int, default=defaults.seed,
                    help="traffic-schedule seed")
    ap.add_argument("--chaos", default=defaults.chaos,
                    help='named fault plan (see faults/plan.py), "" = off')
    ap.add_argument("--chaos-seed", type=int, default=defaults.chaos_seed)
    ap.add_argument("--chaos-scale", type=float, default=defaults.chaos_scale)
    ap.add_argument("--interactive-fraction", type=float,
                    default=defaults.interactive_fraction)
    ap.add_argument("--interactive-deadline-ms", type=int,
                    default=defaults.interactive_deadline_ms)
    ap.add_argument("--bulk-deadline-ms", type=int, default=defaults.bulk_deadline_ms)
    ap.add_argument("--max-retries", type=int, default=defaults.max_retries)
    ap.add_argument("--retry-backoff", type=float, default=defaults.retry_backoff_s)
    ap.add_argument("--window", type=float, default=defaults.batch_window_s)
    ap.add_argument("--max-batch", type=int, default=defaults.batch_max_batch)
    ap.add_argument("--max-queue-depth", type=int, default=defaults.batch_max_queue_depth)
    ap.add_argument("--manifest-timeout", type=float, default=defaults.manifest_timeout_s)
    ap.add_argument("--warmup", type=int, default=defaults.warmup_signs,
                    help="unmeasured pre-clock signs (absorb first-use costs)")
    ap.add_argument("--timeout", type=float, default=defaults.wait_timeout_s)
    ap.add_argument("--out", default="",
                    help=f"write the JSON report here ({OUT_GLOB}; default: stdout only)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress cluster logs, print only the report")
    args = ap.parse_args()
    if args.out and not fnmatch.fnmatch(os.path.basename(args.out), OUT_GLOB):
        ap.error(f"--out must match {OUT_GLOB}")

    log.init(level="ERROR" if args.quiet else "INFO")
    cfg = SoakConfig(
        n_nodes=args.nodes,
        threshold=args.threshold,
        n_wallets=args.wallets,
        n_sign=args.signs,
        n_keygen=args.keygens,
        n_reshare=args.reshares,
        burst_size=args.burst,
        burst_gap_s=args.burst_gap,
        seed=args.seed,
        interactive_fraction=args.interactive_fraction,
        interactive_deadline_ms=args.interactive_deadline_ms,
        bulk_deadline_ms=args.bulk_deadline_ms,
        max_retries=args.max_retries,
        retry_backoff_s=args.retry_backoff,
        chaos=args.chaos,
        chaos_seed=args.chaos_seed,
        chaos_scale=args.chaos_scale,
        batch_window_s=args.window,
        batch_max_batch=args.max_batch,
        batch_max_queue_depth=args.max_queue_depth,
        manifest_timeout_s=args.manifest_timeout,
        warmup_signs=args.warmup,
        wait_timeout_s=args.timeout,
    )
    report = run_soak(cfg, device=args.device)
    # keep stdout reviewable: the embedded trace document is for Perfetto,
    # not eyeballs — elide it from the console copy only
    console = dict(report)
    trace = console.pop("trace", {})
    console["trace_events"] = len(trace.get("traceEvents", []))
    print(json.dumps(console, indent=2))
    if args.out:
        write_report(report, args.out)
        stem = os.path.splitext(args.out)[0]
        with open(stem + ".prom", "w") as f:
            f.write(report.get("prometheus", ""))
        print(f"report written to {args.out} "
              f"(+ {stem}.prom metrics sidecar)", file=sys.stderr)
    return 0 if report["accounting_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
