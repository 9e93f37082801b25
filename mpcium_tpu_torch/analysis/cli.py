"""``mpclint`` command-line interface over the port (``mpcium_tpu_torch``).

Exit codes: 0 clean (every finding grandfathered, no stale entries),
1 violations (new findings, stale baseline entries, or parse errors),
2 operator error (bad baseline file, bad arguments).

Usage:
    python -m mpcium_tpu_torch.analysis.cli [paths...]      # gate on baseline
    python -m mpcium_tpu_torch.analysis.cli --no-baseline   # gate on zero
    python -m mpcium_tpu_torch.analysis.cli --write-baseline
    python -m mpcium_tpu_torch.analysis.cli --list-rules
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

from .baseline import DEFAULT_BASELINE, BaselineError, load_baseline, write_baseline
from .core import run_lint
from .rules import rule_catalog


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpclint",
        description="static analysis of the mpcium_tpu_torch package",
    )
    p.add_argument(
        "paths",
        nargs="*",
        type=Path,
        help="files/dirs to lint (default: the mpcium_tpu_torch package)",
    )
    p.add_argument(
        "--baseline",
        type=Path,
        default=None,
        help=f"baseline file (default: <repo>/{DEFAULT_BASELINE})",
    )
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore the baseline: any finding fails",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="grandfather every current finding (edit justifications before commit)",
    )
    p.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    p.add_argument(
        "-q", "--quiet", action="store_true", help="summary line only"
    )
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    out = sys.stdout

    if args.list_rules:
        for rule in rule_catalog():
            out.write(f"{rule.id}  {rule.summary}\n")
        return 0

    root = _repo_root()
    baseline_path = args.baseline or (root / DEFAULT_BASELINE)
    t0 = time.monotonic()
    result = run_lint(paths=args.paths or None, root=root)
    elapsed = time.monotonic() - t0

    for err in result.parse_errors:
        out.write(f"PARSE ERROR: {err}\n")

    if args.write_baseline:
        b = write_baseline(baseline_path, result.findings, "")
        out.write(
            f"wrote {len(b.entries)} entries to {baseline_path} — edit each "
            f"justification before committing\n"
        )
        return 0

    if args.no_baseline:
        new, grandfathered, stale = list(result.findings), [], []
    else:
        try:
            baseline = load_baseline(baseline_path)
        except BaselineError as e:
            out.write(f"BASELINE ERROR: {e}\n")
            return 2
        # standalone mpclint runs only the MPL rules — MPF staleness is
        # scripts/torch_check_all.py's business (it runs both analyzers)
        new, grandfathered, stale = baseline.split(
            result.findings, scope=("MPL",)
        )

    if not args.quiet:
        for f in new:
            out.write(f.render() + "\n")
        for fp in stale:
            out.write(
                f"STALE BASELINE ENTRY: {fp} — the finding no longer fires; "
                f"delete it from {baseline_path.name}\n"
            )
    out.write(
        f"mpclint: {result.files_scanned} files in {elapsed:.2f}s — "
        f"{len(new)} new, {len(grandfathered)} grandfathered, "
        f"{len(stale)} stale\n"
    )
    failed = bool(new or stale or result.parse_errors)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
