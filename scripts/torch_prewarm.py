#!/usr/bin/env python3
"""Pre-warm the port's serving set: run each warm-manifest bucket once.

The port of ``scripts/prewarm.py``, over ``mpcium_tpu_torch/warm/``.
The manifest (``warm/manifest.build_manifest``: the serving templates ×
``engine/buckets`` pow-2 buckets, hot shapes first) is walked by
``warm/prewarm.prewarm`` on ``--device``: each entry drives its engine
or party at that shape once, which pays the first-use costs there (K0's
build or load, the device context, the Barrett contexts and comb
tables). The port compiles nothing per shape, so there is no compile
cache to fill and no ``--cache-dir``: the report ``WARM_MANIFEST.json``
goes to ``--out`` (default: ``warm_cache_<host>`` under the current
directory, ``warm/prewarm.default_cache_dir``).

    python scripts/torch_prewarm.py --schemes eddsa --max-b 64   # warm, on the GPU
    python scripts/torch_prewarm.py --device cpu --schemes eddsa --max-b 2
    python scripts/torch_prewarm.py --list    # print the work-list
    python scripts/torch_prewarm.py --check   # exit 1 on a manifest gap

``--list`` and ``--check`` import neither torch nor numpy. The walk
raises without a GPU unless given ``--device cpu``; it prints the
report's totals and K0's counters over the walk, and exits 1 when an
entry failed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

from mpcium_tpu_torch.perf.ledger import GPU_HISTORY_FILE  # noqa: E402
from mpcium_tpu_torch.warm import manifest as wm  # noqa: E402


def _split(text: str):
    return tuple(s.strip() for s in text.split(",") if s.strip())


def _build(args) -> dict:
    schemes = _split(args.schemes) or None
    buckets = tuple(int(b) for b in _split(args.buckets)) or wm.BUCKETS
    traffic = wm.load_traffic(
        args.ledger or str(_ROOT / "COMPILE_LEDGER.json"),
        args.history or str(_ROOT / GPU_HISTORY_FILE),
    )
    return wm.build_manifest(wm.default_knobs(args.threshold), buckets=buckets,
                             schemes=schemes, max_b=args.max_b, traffic=traffic)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--schemes", default="",
                   help="comma list of eddsa,ecdsa,dkg,reshare (default all)")
    p.add_argument("--max-b", type=int, default=None,
                   help=f"largest batch bucket to warm (default: all {len(wm.BUCKETS)})")
    p.add_argument("--buckets", default="", help="explicit comma list of pow-2 buckets")
    p.add_argument("--threshold", "--q", type=int, default=None, dest="threshold",
                   help="mpc threshold t (warm quorum q = t+1; default 1)")
    p.add_argument("--budget-s", type=float, default=1800.0,
                   help="wall-clock budget; remaining entries are skipped")
    p.add_argument("--ledger", default="",
                   help="COMPILE_LEDGER.json for traffic priority")
    p.add_argument("--history", default="",
                   help=f"{GPU_HISTORY_FILE} for traffic priority")
    p.add_argument("--out", default="",
                   help="report dir for WARM_MANIFEST.json (default: ./warm_cache_<host>)")
    p.add_argument("--device", default=None,
                   help="torch device of the walk (default: the GPU; 'cpu' runs the plain path)")
    p.add_argument("--list", action="store_true",
                   help="print the work-list and exit (no torch import)")
    p.add_argument("--check", action="store_true",
                   help="exit 1 on a knob dimension without warm values (no torch import)")
    args = p.parse_args(argv)

    if args.check:
        man = wm.build_manifest(wm.default_knobs(args.threshold))
        for prob in man["gaps"]:
            print(f"WARM GAP: {prob}")
        print(f"warmcheck: {man['counts']['entries']} signatures over "
              f"{man['counts']['serving_templates']} serving templates × "
              f"{man['counts']['buckets']} buckets — {len(man['gaps'])} problem(s)")
        return 1 if man["gaps"] else 0

    manifest = _build(args)
    if args.list:
        for e in manifest["entries"]:
            print(f"{e['engine']:16s} {e['shape']:32s} priority={e['priority']:.1f}")
        print(f"{manifest['counts']['entries']} entries")
        return 0

    # torch from here on
    from mpcium_tpu_torch.device import resolve
    from mpcium_tpu_torch.warm import prewarm as pw

    from mpcium_tpu_torch.ops import mulmod as K

    dev = resolve(args.device)  # raises without a GPU unless told 'cpu'
    out = args.out or pw.default_cache_dir(os.getcwd())
    K.reset_counters()
    report = pw.prewarm(manifest, args.budget_s, report_dir=out, device=dev)
    t = report["totals"]
    print(json.dumps(t, indent=1, sort_keys=True))
    print(json.dumps({"k0": K.counters()}))  # the walk's launches of K0
    print(f"report: {report.get('path', '(unwritten)')}")
    return 0 if t["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
