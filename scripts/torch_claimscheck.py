#!/usr/bin/env python3
"""The port's claims drift gate over the committed claims renders.

The port of ``scripts/claimscheck.py``, over the port's
``perf/claims.py`` and ``perf/ledger.build_history``.

Check mode (default): registry hygiene (no unknown metric, no untracked
ROADMAP headline number) and byte drift of the committed ``CLAIMS.json``
and ``CLAIMS.md`` against the port's evaluation of the same artifact
corpus. Exit 0 clean, 1 problems.

``--regen --out DIR`` writes both renders into ``DIR`` only: the
committed renders at the root are the JAX package's, and this script
never rewrites them (``--regen`` without ``--out`` is refused).

    python scripts/torch_claimscheck.py
    python scripts/torch_claimscheck.py --regen --out DIR

It reads files only and touches no device.
"""
from __future__ import annotations

import argparse
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from mpcium_tpu_torch.perf import claims, ledger  # noqa: E402


def regen(out_dir: str) -> int:
    records = ledger.build_history(_ROOT)
    problems = claims.registry_problems(records)
    for prob in problems:
        print(f"CLAIMS: {prob}")
    evaluated = claims.evaluate(records)
    os.makedirs(out_dir, exist_ok=True)
    for basename, text in ((claims.CLAIMS_JSON, claims.render_json(evaluated)),
                           (claims.CLAIMS_MD, claims.render_md(evaluated))):
        with open(os.path.join(out_dir, basename), "w") as f:
            f.write(text)
        print(f"wrote {os.path.join(out_dir, basename)}")
    s = claims.summary(evaluated)
    print(f"claims: {s['claimed']} claimed, {s['owed']} owed, {s['stale']} stale")
    return 1 if problems else 0


def check() -> int:
    problems = claims.check_problems(_ROOT)
    for prob in problems:
        print(f"CLAIMS: {prob}")
    s = claims.summary(claims.evaluate(ledger.build_history(_ROOT)))
    print(f"claimscheck: {s['claimed']} claimed, {s['owed']} owed, "
          f"{s['stale']} stale — "
          f"{'%d problem(s)' % len(problems) if problems else 'clean'}")
    return 1 if problems else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--regen", action="store_true",
                   help="write CLAIMS.json/CLAIMS.md from the corpus into --out")
    p.add_argument("--out", default="",
                   help="directory for --regen's renders (required with --regen)")
    args = p.parse_args(argv)
    if args.regen:
        if not args.out:
            p.error("--regen writes only under --out DIR; the root's CLAIMS.* are "
                    "the JAX package's")
        return regen(args.out)
    return check()


if __name__ == "__main__":
    raise SystemExit(main())
