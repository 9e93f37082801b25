#!/usr/bin/env python
"""The port's measurement round as one command: a resumable campaign on the card.

The port of ``scripts/tpu_round.py``. On a machine with a GPU::

    python scripts/torch_gpu_round.py

runs the round as a step list (``mpcium_tpu_torch/perf/campaign.py``):
the flagship bench (``python -m mpcium_tpu_torch.bench``, with its
secondary metrics, the OT variant with checks on and off, and the
1024 → 16384 batch sweep), the pipeline K ∈ {1, 2, 4} idle A/B on the card
(``scripts/torch_bench_pipeline.py``), the batched Ed25519 bench, the
native-against-card OT crossover (``scripts/torch_bench_ot_host.py
--device``) and the two-process warm boot. Each step runs in its own
subprocess under its own timeout, and the state file is checkpointed
after every step: the same command run again resumes where a cut run
stopped. The report lands as ``GPU_CAMPAIGN_r<NN>.json`` (numbered from
the ``GPU_CAMPAIGN_r*.json`` already at the root) and is ingested into the
port's own history, ``GPU_PERF_history.jsonl``; nothing of the JAX
package's records (``PERF_history.jsonl``, ``CLAIMS.*``, the dashboard) is
written.

``--rehearse`` runs the same steps on the CPU (``--device cpu``) at tiny
sizes; ``--plan steps.json`` substitutes an explicit step list (tests);
``--ingest-only REPORT`` copies nothing and only rebuilds the history.

Internal step modes (the runner calls this script again): ``--ed25519``
(batched Ed25519 sigs/s) and ``--warmboot`` (a process that runs
``warm/prewarm`` and builds K0, then a cold process's first sign). The
port compiles no executable per shape, so the warm boot reports K0's
build verdict (``hit`` when its library is already on disk) where the
JAX round reports XLA cache hits.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _ROOT)

_PROBE = "import torch; assert torch.cuda.is_available()"
STATE_DIR = ".gpu_campaign"  # under the root: the state file, heartbeat, step outputs


def _probe_gpu(timeout_s: int = 120) -> bool:
    """A GPU answers in a child process: the runner itself never touches
    the card its steps measure."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE], timeout=timeout_s,
                           capture_output=True)
        return r.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


# -- internal step modes -----------------------------------------------------


def run_ed25519(b: int, device) -> int:
    """Batched Ed25519 (device-hashed challenges): one warm measured sign."""
    import secrets

    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.perf.envfp import env_fingerprint

    ids = ["n0", "n1", "n2"]
    shares = eb.dealer_keygen_batch(b, ids, 1, rng=secrets)
    messages = [secrets.token_bytes(32) for _ in range(b)]
    signer = eb.BatchedCoSigners(ids[:2], shares[:2], rng=secrets, device=device)
    sigs, ok = signer.sign(messages)  # warm-up
    assert ok.all()
    t0 = time.perf_counter()
    sigs, ok = signer.sign(messages)
    wall = time.perf_counter() - t0
    assert ok.all()
    print(json.dumps({
        "ed25519_2of3_sigs_per_sec": round(b / wall, 1) if wall else 0.0,
        "ed25519_batch": b,
        "wall_s": round(wall, 4),
        "env": env_fingerprint(),
    }))
    _stop_pipe_host()
    return 0


def _stop_pipe_host() -> None:
    mod = sys.modules.get("mpcium_tpu_torch.engine.pipeline")
    if mod is not None:
        with mod._POOL_LOCK:
            pool, mod._HOST_POOL = mod._HOST_POOL, None
        if pool is not None:
            pool.shutdown(wait=True)


_PREWARM_SNIPPET = r"""
import json, sys
import torch
from mpcium_tpu_torch.warm import manifest as wm, prewarm as pw
from mpcium_tpu_torch.perf import compile_watch

dev = torch.device(sys.argv[1])
manifest = wm.build_manifest(wm.default_knobs(), buckets=[int(sys.argv[3])],
                             schemes=[sys.argv[2]])
report = pw.prewarm(manifest, float(sys.argv[4]), report_dir=sys.argv[5], device=dev)
if dev.type == "cuda":
    from mpcium_tpu_torch.ops import mulmod
    mulmod.build()  # leaves K0's library on disk for the cold process
print("PREWARM_RESULT " + json.dumps({"totals": report["totals"],
                                      "compile": compile_watch.entries()}))
"""

_BOOT_SNIPPET = r"""
import json, secrets, sys, time
t0 = time.monotonic()
import torch
from mpcium_tpu_torch.perf import compile_watch
from mpcium_tpu_torch.engine import eddsa_batch as eb

dev = torch.device(sys.argv[1])
b = int(sys.argv[2])
ids = [f"warm{i}" for i in range(3)]
shares = eb.dealer_keygen_batch(b, ids, 1, rng=secrets)
signer = eb.BatchedCoSigners(ids[:2], shares[:2], rng=secrets, device=dev)
sigs, ok = signer.sign([bytes([i % 256]) * 32 for i in range(b)])
assert ok.all(), "warm boot produced invalid signatures"
first_sign_s = time.monotonic() - t0
if dev.type == "cuda":
    from mpcium_tpu_torch.ops import mulmod
    mulmod.build()  # K0's build verdict: hit when its library is on disk
entries = compile_watch.entries()
print("WARMBOOT_RESULT " + json.dumps({
    "first_sign_s": round(first_sign_s, 2),
    "cache_hits": sum(1 for e in entries if e["cache"] == "hit"),
    "cache_misses": sum(1 for e in entries if e["cache"] == "miss"),
    "entries": len(entries),
}))
mod = sys.modules.get("mpcium_tpu_torch.engine.pipeline")
if mod is not None and mod._HOST_POOL is not None:
    mod._HOST_POOL.shutdown(wait=True)
"""


def _result_line(stdout: str, tag: str):
    line = next((ln for ln in stdout.splitlines() if ln.startswith(tag + " ")), None)
    return None if line is None else json.loads(line[len(tag) + 1:])


def run_warmboot(out_dir: str, scheme: str, bucket: int, budget_s: float, device: str) -> int:
    """The two-process warm boot: a process runs ``warm/prewarm`` over the
    manifest's ``scheme`` entries at ``bucket`` (and builds K0 on the card),
    then a cold process sharing only the disk signs once and reports its
    first-signature latency and K0's build verdict."""
    from mpcium_tpu_torch.perf.envfp import env_fingerprint

    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH", "")) if p))
    r = subprocess.run(
        [sys.executable, "-c", _PREWARM_SNIPPET, device, scheme, str(bucket), str(budget_s),
         out_dir],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=budget_s + 600,
    )
    warm = _result_line(r.stdout, "PREWARM_RESULT") if r.returncode == 0 else None
    if warm is None:
        print(json.dumps({"dnf": True,
                          "reason": f"prewarm rc={r.returncode}: {r.stderr[-300:]}"}))
        return 1
    if warm["totals"]["failed"]:
        print(json.dumps({"dnf": True, "reason": f"prewarm failed entries: {warm['totals']}"}))
        return 1
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-c", _BOOT_SNIPPET, device, str(bucket)],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=budget_s,
    )
    boot = _result_line(r.stdout, "WARMBOOT_RESULT") if r.returncode == 0 else None
    if boot is None:
        print(json.dumps({"dnf": True,
                          "reason": f"cold boot rc={r.returncode}: {r.stderr[-300:]}"}))
        return 1
    print(json.dumps({
        "warmboot_first_sign_s": boot["first_sign_s"],
        "warmboot_cache_hits": boot["cache_hits"],
        "warmboot_cache_misses": boot["cache_misses"],
        "warmboot_entries": boot["entries"],
        "warmboot_wall_s": round(time.monotonic() - t0, 2),
        "prewarm_totals": warm["totals"],
        "scheme": scheme,
        "bucket": bucket,
        "env": env_fingerprint(),
    }))
    return 0


# -- plans -------------------------------------------------------------------


def _bench_parse(stdout: str) -> dict:
    from mpcium_tpu_torch.perf.campaign import last_json_line

    doc = last_json_line(stdout)
    if "metric" not in doc:
        raise ValueError("bench printed JSON without a metric field")
    return doc


def default_plan(rehearse: bool, state_dir: str):
    """The round as steps. Rehearse: the same steps on the CPU at tiny
    sizes; live: the card, the round's sizes and budgets (a chip call
    lasts at most an hour, so each step fits in one)."""
    from mpcium_tpu_torch.perf.campaign import Step

    py = sys.executable
    bench = [py, "-m", "mpcium_tpu_torch.bench"]
    dev = ["--device", "cpu"] if rehearse else []
    pipeline_out = os.path.join(state_dir, "pipeline_ab.json")
    warm_dir = os.path.join(state_dir, "warm_boot")

    if rehearse:
        # the flagship skips the OT pass and the secondary suite (each has
        # a step of its own) so the rehearsal stays short on the CPU
        flagship_env = {"MPCIUM_BENCH_B": "2", "MPCIUM_BENCH_RUNS": "1",
                        "MPCIUM_BENCH_B_SWEEP": "none", "MPCIUM_BENCH_NO_OT": "1",
                        "MPCIUM_BENCH_NO_SECONDARY": "1", "MPCIUM_BENCH_WATCHDOG_S": "1500"}
        return [
            Step("flagship", bench + dev, env=flagship_env, timeout_s=1700,
                 parse=_bench_parse, cwd=_ROOT),
            Step("pipeline_ab",
                 [py, os.path.join(_HERE, "torch_bench_pipeline.py"), "--device", "cpu",
                  "--b", "8", "--k", "1,2", "--lenient", "--out", pipeline_out],
                 timeout_s=900, cwd=_ROOT),
            Step("ed25519", [py, os.path.abspath(__file__), "--ed25519", "--b", "8"] + dev,
                 timeout_s=600, cwd=_ROOT),
            Step("ot_crossover",
                 [py, os.path.join(_HERE, "torch_bench_ot_host.py"), "--m", "16384",
                  "--runs", "1", "--device", "cpu"],
                 timeout_s=600, cwd=_ROOT),
            Step("warm_boot",
                 [py, os.path.abspath(__file__), "--warmboot", warm_dir, "--scheme", "eddsa",
                  "--bucket", "2"] + dev,
                 timeout_s=900, cwd=_ROOT),
        ]
    # live: the checks-on/off A/B and the 1024 → 16384 sweep run inside the
    # flagship bench; each sweep point gets 1,200 s, cut to what the bench's
    # watchdog leaves (a B=4096 point took 235 s on the card, PERF.md §6)
    return [
        Step("flagship", bench,
             env={"MPCIUM_BENCH_WATCHDOG_S": "3000", "MPCIUM_BENCH_SWEEP_TIMEOUT_S": "1200"},
             timeout_s=3100, parse=_bench_parse, cwd=_ROOT),
        Step("pipeline_ab",
             [py, os.path.join(_HERE, "torch_bench_pipeline.py"), "--device",
              "--b", "4096", "--k", "1,2,4", "--out", pipeline_out],
             timeout_s=1800, cwd=_ROOT),
        Step("ed25519", [py, os.path.abspath(__file__), "--ed25519", "--b", "4096"],
             timeout_s=900, cwd=_ROOT),
        Step("ot_crossover",
             [py, os.path.join(_HERE, "torch_bench_ot_host.py"), "--device"],
             timeout_s=900, cwd=_ROOT),
        Step("warm_boot",
             [py, os.path.abspath(__file__), "--warmboot", warm_dir, "--scheme", "eddsa",
              "--bucket", "4096"],
             timeout_s=1800, cwd=_ROOT),
    ]


def load_plan(path: str):
    """An explicit plan file: a JSON list of Step keyword arguments."""
    from mpcium_tpu_torch.perf.campaign import Step

    with open(path) as f:
        entries = json.load(f)
    return [
        Step(e["id"], e["argv"], env=e.get("env"), timeout_s=e.get("timeout_s", 600),
             needs=e.get("needs", ()), cwd=e.get("cwd"))
        for e in entries
    ]


# -- the report and the port's history ----------------------------------------


def next_campaign_basename(root: str = _ROOT) -> str:
    """``GPU_CAMPAIGN_r<NN>.json``, one past the highest at ``root`` (the JAX
    package's ``CAMPAIGN_r*.json`` do not count)."""
    top = 0
    for p in glob.glob(os.path.join(root, "GPU_CAMPAIGN_r*.json")):
        m = re.search(r"_r(\d+)\.json$", p)
        if m:
            top = max(top, int(m.group(1)))
    return f"GPU_CAMPAIGN_r{top + 1:02d}.json"


def ingest(root: str = _ROOT) -> str:
    """Rebuild the port's history from its artifacts at ``root``; returns
    its path. The JAX package's history and claims stay untouched."""
    from mpcium_tpu_torch.perf import ledger

    records = ledger.build_gpu_history(root)
    path = os.path.join(root, ledger.GPU_HISTORY_FILE)
    ledger.write_history(records, path)
    print(f"history: {len(records)} records -> {path}")
    return path


# -- main --------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rehearse", action="store_true",
                   help="every step on the CPU at tiny sizes (harness proof)")
    p.add_argument("--plan", help="explicit step-list JSON (tests)")
    p.add_argument("--state", help="campaign state file "
                   f"(default <root>/{STATE_DIR}/GPU_CAMPAIGN_state.json)")
    p.add_argument("--out", help="campaign report path")
    p.add_argument("--heartbeat", help=".prom heartbeat path")
    p.add_argument("--name", help="campaign name override")
    p.add_argument("--no-ingest", action="store_true",
                   help="do not rebuild GPU_PERF_history.jsonl")
    p.add_argument("--ingest-only", action="store_true",
                   help="only rebuild GPU_PERF_history.jsonl from the root's artifacts")
    # internal step modes
    p.add_argument("--ed25519", action="store_true")
    p.add_argument("--b", type=int, default=4096)
    p.add_argument("--warmboot", metavar="OUT_DIR")
    p.add_argument("--scheme", default="eddsa")
    p.add_argument("--bucket", type=int, default=2)
    p.add_argument("--budget-s", type=float, default=1200.0)
    p.add_argument("--device", default=None,
                   help="the step modes' torch device (default: the GPU)")
    args = p.parse_args(argv)

    if args.ingest_only:
        ingest()
        return 0
    if args.ed25519 or args.warmboot:
        from mpcium_tpu_torch.device import resolve

        dev = resolve(args.device)  # raises without a GPU unless --device cpu
        if args.ed25519:
            return run_ed25519(args.b, dev)
        return run_warmboot(args.warmboot, args.scheme, args.bucket, args.budget_s, str(dev))

    from mpcium_tpu_torch.perf.campaign import HEARTBEAT_BASENAME, STATE_BASENAME, Campaign

    state_dir = (os.path.dirname(os.path.abspath(args.state)) if args.state
                 else os.path.join(_ROOT, STATE_DIR))
    os.makedirs(state_dir, exist_ok=True)
    state_path = args.state or os.path.join(state_dir, STATE_BASENAME)
    heartbeat = args.heartbeat or os.path.join(state_dir, HEARTBEAT_BASENAME)

    if args.plan:
        steps = load_plan(args.plan)
        name = args.name or "custom"
        out = args.out or os.path.join(state_dir, "GPU_CAMPAIGN_custom.json")
    elif args.rehearse:
        steps = default_plan(True, state_dir)
        name = args.name or "rehearsal"
        out = args.out or os.path.join(state_dir, "GPU_CAMPAIGN_rehearsal.json")
    else:
        if not _probe_gpu():
            print("torch_gpu_round: no CUDA device answers — the round runs on the "
                  "card; use --rehearse for the CPU harness proof", file=sys.stderr)
            return 2
        steps = default_plan(False, state_dir)
        name = args.name or "gpu-round"
        out = args.out or os.path.join(_ROOT, next_campaign_basename())

    campaign = Campaign(name, steps, state_path=state_path,
                        rehearse=args.rehearse or bool(args.plan), heartbeat_path=heartbeat)
    report = campaign.run()
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, out)
    print(f"campaign: report -> {out} "
          f"({report['steps_done']}/{report['steps_total']} steps, "
          f"{report['steps_dnf']} DNF)")
    if not args.no_ingest and not args.rehearse and not args.plan:
        ingest()
    return 0 if report["complete"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
