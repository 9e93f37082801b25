#!/usr/bin/env python3
"""One-pass static gate over the port: mpclint + mpcflow + budget drift.

Parses ``mpcium_tpu_torch`` once (analysis/core.parse_project) and hands
the same ParsedFile list to both analyzers. Their findings gate against
``mpcium_tpu_torch/data/mpclint_baseline.json``, fail-closed both ways
(new findings fail AND stale entries fail), and the committed
``mpcium_tpu_torch/data/host_transfer_budget.json`` must match the
sweep byte for byte.

Exit codes: 0 clean, 1 violations/drift, 2 operator error.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

from mpcium_tpu_torch.analysis.baseline import (  # noqa: E402
    DEFAULT_BASELINE,
    BaselineError,
    load_baseline,
)
from mpcium_tpu_torch.analysis.core import lint_parsed, parse_project  # noqa: E402
from mpcium_tpu_torch.analysis.flow import build_budget, run_flow_parsed  # noqa: E402
from mpcium_tpu_torch.analysis.rules import all_rules  # noqa: E402

from torch_mpcflow_budget import BUDGET_FILE, render  # noqa: E402


def main(argv=None) -> int:
    out = sys.stdout
    t0 = time.monotonic()

    # one parse, two analyzers
    files, parse_errors = parse_project([_ROOT / "mpcium_tpu_torch"], root=_ROOT)
    lint_result = lint_parsed(files, all_rules(), parse_errors=parse_errors)
    flow_result, sites = run_flow_parsed(files)
    findings = lint_result.findings + flow_result.findings

    for err in parse_errors:
        out.write(f"PARSE ERROR: {err}\n")

    baseline_path = _ROOT / DEFAULT_BASELINE
    try:
        baseline = load_baseline(baseline_path)
    except BaselineError as e:
        out.write(f"BASELINE ERROR: {e}\n")
        return 2
    new, grandfathered, stale = baseline.split(findings)

    for f in new:
        out.write(f.render() + "\n")
    for fp in stale:
        out.write(
            f"STALE BASELINE ENTRY: {fp} — the finding no longer fires; "
            f"delete it from {baseline_path.name}\n"
        )

    budget_path = _ROOT / BUDGET_FILE
    budget_text = render(build_budget(sites))
    drifted = not budget_path.exists() or budget_path.read_text() != budget_text
    if drifted:
        out.write(
            f"BUDGET DRIFT: {BUDGET_FILE} does not match the sweep — "
            f"regenerate with scripts/torch_mpcflow_budget.py and review the diff\n"
        )

    elapsed = time.monotonic() - t0
    out.write(
        f"torch_check_all: {len(files)} files in {elapsed:.2f}s — "
        f"{len(new)} new, {len(grandfathered)} grandfathered, "
        f"{len(stale)} stale, budget "
        f"{'DRIFTED' if drifted else 'in sync'}\n"
    )
    return 1 if (new or stale or parse_errors or drifted) else 0


if __name__ == "__main__":
    raise SystemExit(main())
