#!/usr/bin/env python3
"""The port's statistical perf-regression gate over its micro-benches.

The port of ``scripts/perfcheck.py``. It runs the port's micro-benches
(``mpcium_tpu_torch/perf/microbench.py``: host rows, and device rows on
``--device``) and compares them with the committed baseline
``mpcium_tpu_torch/data/perf_baseline_micro_gpu.json`` under
``perf/statcheck.gate`` (Mann-Whitney + effect floor + bootstrap CI).

Host honesty, as in JAX: the baseline is stamped with the host
fingerprint (``perf/envfp.host_fingerprint``) and the ledger key of the
host and device it was taken on (``gpu/<host>/1x<kind>``). Where both
match, the gate is strict: exit 1 on a regression that one re-measurement
of the flagged rows confirms. On another host or device the comparison
is printed for information and the exit code is 0: absolute timings do
not carry across hosts, and the chip hosts differ from call to call.

    python scripts/torch_perfcheck.py [--device cpu]      # the gate
    python scripts/torch_perfcheck.py --update-baseline   # re-measure, rewrite the baseline
    python scripts/torch_perfcheck.py --inject-slowdown 4 # the gate must fail (self-test)
    python scripts/torch_perfcheck.py --regen-history     # GPU_PERF_history.jsonl + dashboard

Without a GPU and without ``--device cpu`` the measuring modes raise;
``--regen-history`` reads only the committed files.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mpcium_tpu_torch.perf import envfp, ledger, microbench, report, statcheck  # noqa: E402

BASELINE_FILE = ROOT / "mpcium_tpu_torch" / "data" / "perf_baseline_micro_gpu.json"
HISTORY_PATH = ROOT / ledger.GPU_HISTORY_FILE
DASHBOARD_PATH = ROOT / "GPU_PERFORMANCE_dashboard.md"

# render_dashboard is the JAX package's text; the port's names its own
# generator and artifacts
_HEADER = ("Generated by `scripts/perfcheck.py --regen-history` from the\n"
           "committed `BENCH_*` / `SOAK_*` / `MULTICHIP_*` artifacts — do not\n"
           "edit by hand; CI gates this file against a regeneration. Records\n"
           "are grouped by env fingerprint (`mpcium_tpu/perf/envfp.py`)",
           "Generated by `scripts/torch_perfcheck.py --regen-history` from the\n"
           "committed `GPU_BENCH_*` / `GPU_CAMPAIGN_r*` artifacts — do not\n"
           "edit by hand; CI gates this file against a regeneration. Records\n"
           "are grouped by env fingerprint (`mpcium_tpu_torch/perf/envfp.py`)")


def device_key(dev) -> str:
    """The ledger key of this host and the device the rows run on."""
    import torch

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return envfp.fingerprint_key({"platform": "gpu" if dev.type == "cuda" else "cpu",
                                  "host": envfp.host_fingerprint(),
                                  "device_count": 1, "device_kind": kind})


def _card(dev):
    if dev.type != "cuda":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _load_baseline():
    try:
        with open(BASELINE_FILE) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _measure(names, samples: int, dev) -> dict:
    """The named rows, the device rows on ``dev``."""
    return {name: (microbench.ALL_BENCHES[name](samples, device=dev)
                   if name in microbench._DEVICE_ROWS else microbench.ALL_BENCHES[name](samples))
            for name in sorted(names) if name in microbench.ALL_BENCHES}


def write_baseline(samples: int, dev) -> int:
    benches = microbench.run_all(samples, device=dev)
    doc = {
        "host": envfp.host_fingerprint(),
        "fingerprint": device_key(dev),
        "card": _card(dev),
        "python": ".".join(str(v) for v in sys.version_info[:3]),
        "torch": envfp.torch_version(),
        "samples_per_bench": samples,
        "benches": {name: {"samples": vals} for name, vals in sorted(benches.items())},
    }
    with open(BASELINE_FILE, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"perfcheck: baseline rewritten for {doc['fingerprint']} -> {BASELINE_FILE.name}")
    return 0


def regen_history() -> int:
    records = ledger.build_gpu_history(str(ROOT))
    ledger.write_history(records, str(HISTORY_PATH))
    dashboard = report.render_dashboard(records, micro_baseline=_load_baseline())
    if _HEADER[0] not in dashboard:
        raise RuntimeError("report.render_dashboard's header changed")
    with open(DASHBOARD_PATH, "w") as f:
        f.write(dashboard.replace(*_HEADER))
    print(f"perfcheck: {len(records)} artifact records -> {HISTORY_PATH.name}, "
          f"{DASHBOARD_PATH.name}")
    return 0


def _scaled(currents: dict, slowdown: float) -> dict:
    if slowdown == 1.0:
        return currents
    return {k: [v * slowdown for v in vals] for k, vals in currents.items()}


def run_gate(baseline: dict, samples: int, slowdown: float, strict: bool,
             dev) -> statcheck.GateResult:
    currents = _scaled(microbench.run_all(samples, device=dev), slowdown)
    baselines = {name: b.get("samples") or []
                 for name, b in (baseline.get("benches") or {}).items()}
    result = statcheck.gate(baselines, currents)
    if strict and not result.ok:
        # one retry absorbs a transient spike without weakening the
        # statistics: a real regression reproduces, a scheduler burp not
        retry_names = {v.bench for v in result.regressions}
        print("perfcheck: regression indicated — re-measuring "
              + ", ".join(sorted(retry_names)) + " once to confirm")
        currents2 = _scaled(_measure(retry_names, samples, dev), slowdown)
        confirm = statcheck.gate({n: baselines[n] for n in currents2}, currents2)
        confirmed = {v.bench for v in confirm.regressions}
        for v in result.verdicts:
            if v.regressed and v.bench not in confirmed:
                v.regressed = False
                v.note = "regression not reproduced on retry"
            elif v.regressed:
                v.note = "confirmed on retry"
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=microbench.DEFAULT_SAMPLES)
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--inject-slowdown", type=float, default=1.0, metavar="F",
                    help="multiply measured samples by F (gate self-test)")
    ap.add_argument("--regen-history", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the device rows (default: the GPU)")
    args = ap.parse_args(argv)

    if args.regen_history:
        return regen_history()
    from mpcium_tpu_torch.device import resolve

    dev = resolve(args.device)  # raises without a GPU unless told 'cpu'
    if args.update_baseline:
        return write_baseline(args.samples, dev)

    baseline = _load_baseline()
    if baseline is None:
        print(f"perfcheck: no {BASELINE_FILE.name} committed — run --update-baseline first",
              file=sys.stderr)
        return 1

    here = device_key(dev)
    strict = baseline.get("fingerprint") == here
    if not strict:
        print(f"perfcheck: baseline {baseline.get('fingerprint')} != this {here} — "
              "informational comparison only (absolute micro timings are not "
              "portable across hosts)")

    result = run_gate(baseline, args.samples, args.inject_slowdown, strict, dev)
    for v in result.verdicts:
        print("perfcheck:", v.render())
    for note in result.notes:
        print("perfcheck: note:", note)

    if not strict:
        print("perfcheck: OK (foreign host — informational)")
        return 0
    if result.ok:
        print("perfcheck: OK — no regressions")
        return 0
    print(f"perfcheck: FAIL — {len(result.regressions)} regression(s)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
