"""Phases 26 (chaos) and 27 (soak) of ``chip_smoke.py`` alone: run them
in-process as phase 19's child process does, print their lines and hold
them to their checks.

    python3 scripts/torch_chaos_soak_alone.py [N_SIGN ...] [--cpu] [--no-chaos]
        [--wait S]

Each N_SIGN runs one soak with that many signs (the soak's one depth
knob; default chip_smoke's); ``--wait`` overrides the soak's wait for
its last result, ``--no-chaos`` skips phase 26 and ``--cpu`` rehearses
on the CPU (no GPU needed).
"""
import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_sign", type=int, nargs="*")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-chaos", action="store_true")
    ap.add_argument("--wait", type=float, default=0.0)
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"
    if dev == "cuda":
        print(cs.smi(), flush=True)
    if args.wait:
        cs.SOAK_CFG["wait_timeout_s"] = args.wait
    os.environ[cs.T0_ENV] = repr(time.monotonic())
    t0 = time.perf_counter()
    failed = []
    try:
        from mpcium_tpu_torch.utils import log

        log.init(level="WARNING")
        if not args.no_chaos:
            chaos = cs.run_chaos(cs.CHAOS_SEED, dev)
            for row in chaos["drills"]:
                cs.emit({"phase": "chaos_drill", **row})
            cs.emit({**chaos, "drills": [r["drill"] for r in chaos["drills"]], "alone": True})
            cs.check_chaos(chaos)
        for n in args.n_sign or [cs.SOAK_CFG["n_sign"]]:
            cs.SOAK_CFG["n_sign"] = n
            rec = cs.run_soak_phase(dev)
            cs.emit({**rec, "alone": True})
            try:
                cs.check_soak(rec)
            except AssertionError as e:
                failed.append(repr(e))
                print(repr(e), flush=True)
    finally:
        print("script_s", time.perf_counter() - t0, flush=True)
    sys.exit(1 if failed else 0)
