#!/usr/bin/env python3
"""Regenerate the port's host-transfer budget from the mpcflow residency sweep.

The committed ``mpcium_tpu_torch/data/host_transfer_budget.json`` is the
per-phase ledger of every host sync (``.cpu()``, ``.item()``,
``.tolist()``, ``torch.cuda.synchronize``, ``bool(t)``, a call to a
host helper, ...) on a protocol-hot path of ``mpcium_tpu_torch``:
'intentional' sites carry a '# mpcflow: host-ok' reason (wire
boundaries, verdicts that gate the protocol), 'tracked' sites are
baselined debt tied to ROADMAP items. scripts/torch_check_all.py fails
when the committed file drifts from the sweep, so run this after any
change that moves a host transfer.

Usage:
    python scripts/torch_mpcflow_budget.py           # rewrite the JSON
    python scripts/torch_mpcflow_budget.py --check   # exit 1 on drift, write nothing
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

from mpcium_tpu_torch.analysis.flow import build_budget, run_flow  # noqa: E402

BUDGET_FILE = "mpcium_tpu_torch/data/host_transfer_budget.json"


def render(budget: dict) -> str:
    return json.dumps(budget, indent=1, ensure_ascii=False) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--check",
        action="store_true",
        help="compare against the committed file instead of writing",
    )
    args = p.parse_args(argv)

    _, sites = run_flow(root=_ROOT)
    budget = build_budget(sites)
    text = render(budget)
    out = _ROOT / BUDGET_FILE

    if args.check:
        if not out.exists():
            print(f"{BUDGET_FILE} missing — run scripts/torch_mpcflow_budget.py")
            return 1
        if out.read_text() != text:
            print(f"{BUDGET_FILE} is stale — run scripts/torch_mpcflow_budget.py")
            return 1
        print(f"{BUDGET_FILE} in sync")
        return 0

    out.write_text(text)
    phases = budget["phases"]
    total = sum(ph["total_sites"] for ph in phases.values())
    tracked = sum(ph["tracked"] for ph in phases.values())
    print(
        f"wrote {BUDGET_FILE}: {total} sites across {len(phases)} phases "
        f"({tracked} tracked debt, {total - tracked} intentional)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
