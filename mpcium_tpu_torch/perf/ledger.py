"""The bench trajectory ledger: committed perf artifacts, normalized.

The port's copy of the JAX package's ``perf/ledger.py``, with its globs:
every committed ``BENCH_*`` / ``SOAK_*`` / ``MULTICHIP_*`` /
``CAMPAIGN_*`` artifact normalizes into one record stream —
``PERF_history.jsonl`` — keyed by an env-fingerprint group so runs of
one platform never average into another's trend. The port's own
artifacts (``GPU_BENCH_*.json`` from ``python -m mpcium_tpu_torch.bench``
and the step benches, ``GPU_CAMPAIGN_r*.json`` from
``scripts/torch_gpu_round.py``) match none of those globs: they normalize
through the same normalizers into a history of the port's own,
``GPU_PERF_history.jsonl`` (:func:`build_gpu_history`), where the chip
platform is ``gpu``, so a ``gpu`` record is not degraded where a ``tpu``
one is.

Normalization is DETERMINISTIC from the artifact bytes: no wall clock,
no host lookups — the history is a pure function of the committed
artifacts.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional

from .envfp import fingerprint_key

HISTORY_FILE = "PERF_history.jsonl"
ARTIFACT_GLOBS = (
    "BENCH_r*.json", "BENCH_TPU_*.json", "SOAK_*.json", "MULTICHIP_r*.json",
    "BENCH_pipeline_*.json", "CAMPAIGN_*.json",
)
# scratch outputs that may sit untracked in a working tree; the campaign
# STATE checkpoint is runner bookkeeping, never a measurement artifact
_EXCLUDE = {"SOAK_local.json", "CAMPAIGN_state.json"}

_ROUND_RE = re.compile(r"_r(\d+)\.json$")

# the port's own artifacts and history: named apart, so that neither
# history reads the other's records
GPU_HISTORY_FILE = "GPU_PERF_history.jsonl"
GPU_ARTIFACT_GLOBS = ("GPU_BENCH_*.json", "GPU_CAMPAIGN_r*.json")
GPU_PREFIX = "GPU_"

# bench-record numeric fields that are metrics (rates) vs context
_RATE_SUFFIXES = ("_per_sec", "_per_s")
_CONTEXT_KEYS = (
    "batch", "runs", "setup_s", "compile_s", "profiled_run_s",
    "ed25519_batch", "dkg_batch", "reshare_batch", "gg18_ot_mta_batch",
    "gg18_ot_mta_host_s", "gg18_ot_mta_device_s",
    "gg18_ot_mta_overlap_ratio", "gg18_ot_mta_chunks",
    # checks-on/off A/B (active-security overhead contract, PR 16) and
    # the span-derived idle meter — claim inputs, never rate metrics
    "gg18_ot_checks_on_s", "gg18_ot_checks_off_s", "gg18_ot_checks_s",
    "device_idle_fraction", "gg18_ot_mta_device_idle_fraction",
    "elapsed_s", "stale_s",
    # bench_ot_host.py --device: host-vs-device hash-suite crossover
    "m_ots", "threads", "cores",
    "ot_host_stage_s", "ot_device_stage_s", "ot_device_stage_speedup",
    "ot_host_prg_s", "ot_device_prg_s",
    "ot_host_transpose_s", "ot_device_transpose_s",
    "ot_host_pads_s", "ot_device_pads_s",
)


def discover_artifacts(root: str) -> List[str]:
    out = []
    for pat in ARTIFACT_GLOBS:
        for p in glob.glob(os.path.join(root, pat)):
            if os.path.basename(p) not in _EXCLUDE:
                out.append(p)
    return sorted(set(out))


def _round_of(name: str) -> Optional[int]:
    m = _ROUND_RE.search(name)
    return int(m.group(1)) if m else None


def _base_record(source: str, kind: str) -> dict:
    return {
        "source": source,
        "kind": kind,
        "round": _round_of(source),
        "platform": "unknown",
        "degraded": True,
        "fingerprint": None,
        "metrics": {},
        "context": {},
        "measured_at": None,
        "notes": [],
    }


def _normalize_bench_parsed(rec: dict, parsed: dict, chip: str = "tpu") -> None:
    platform = str(parsed.get("platform") or "unknown")
    rec["platform"] = platform
    rec["measured_at"] = parsed.get("measured_at")
    value = parsed.get("value")
    if parsed.get("watchdog_timeout"):
        note = "watchdog fallback record — not a measurement"
        if isinstance(parsed.get("elapsed_s"), (int, float)):
            note += f" (fired after {parsed['elapsed_s']:.1f}s)"
        rec["notes"].append(note)
    metric = parsed.get("metric")
    if metric is not None and isinstance(value, (int, float)):
        rec["metrics"][metric] = float(value)
    for k, v in parsed.items():
        if k == "value" or not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k.endswith(_RATE_SUFFIXES):
            rec["metrics"][k] = float(v)
        elif k in _CONTEXT_KEYS:
            rec["context"][k] = v
    if isinstance(parsed.get("mta"), str):
        rec["context"]["mta"] = parsed["mta"]
    sweep = parsed.get("b_sweep")
    if isinstance(sweep, dict):
        ctx_sweep = {}
        for bsz, entry in sorted(sweep.items()):
            if isinstance(entry, (int, float)) and not isinstance(entry, bool):
                ctx_sweep[bsz] = float(entry)
                rec["metrics"][f"b_sweep_{bsz}_sigs_per_sec"] = float(entry)
            elif isinstance(entry, dict) and entry.get("dnf"):
                # the structured DNF shape bench.py records:
                # {"dnf": true, "reason": "..."} — degraded context, never
                # a metric. Newer entries also stamp elapsed_s + env, so
                # the note attributes the DNF to a host and a timing
                ctx_sweep[bsz] = {"dnf": True}
                note = (
                    f"b_sweep B={bsz} DNF: "
                    f"{entry.get('reason') or 'no reason recorded'}"
                )
                if isinstance(entry.get("elapsed_s"), (int, float)):
                    note += f" after {entry['elapsed_s']:.1f}s"
                dnf_env = entry.get("env")
                if isinstance(dnf_env, dict):
                    note += (
                        f" on {fingerprint_key(dnf_env)}"
                    )
                rec["notes"].append(note)
            else:
                # anything else (legacy bare strings) is flagged verbatim
                # rather than sniffed for substrings
                ctx_sweep[bsz] = {"dnf": True}
                rec["notes"].append(
                    f"b_sweep B={bsz} unstructured entry "
                    f"(pre-structured-DNF artifact): {entry!r}"
                )
        rec["context"]["b_sweep"] = ctx_sweep
    if isinstance(parsed.get("phase_s"), dict) and parsed["phase_s"]:
        if "no_spans" in parsed["phase_s"]:
            rec["notes"].append("no spans recorded (watchdog/DNF run)")
        else:
            rec["context"]["phase_s"] = parsed["phase_s"]
    # the OT-variant pass records its own phase table; the claims
    # engine's r2_mta_ot share derives from this one when present
    if isinstance(parsed.get("gg18_ot_mta_phase_s"), dict) \
            and parsed["gg18_ot_mta_phase_s"] \
            and "no_spans" not in parsed["gg18_ot_mta_phase_s"]:
        rec["context"]["gg18_ot_mta_phase_s"] = parsed["gg18_ot_mta_phase_s"]
    comp = parsed.get("compile")
    if isinstance(comp, dict):
        if isinstance(comp.get("unpredicted"), (int, float)):
            rec["context"]["compile_unpredicted"] = float(comp["unpredicted"])
        if isinstance(comp.get("compiles"), (int, float)):
            rec["context"]["compile_count"] = float(comp["compiles"])
    env = parsed.get("env") if isinstance(parsed.get("env"), dict) else None
    if env:
        rec["env"] = env
    rec["fingerprint"] = fingerprint_key(env, platform_hint=platform)
    # degraded = anything that must never blend into a chip trend:
    # off-chip platforms, watchdog zero-records, stale-fallback carriers
    rec["degraded"] = (
        platform != chip
        or not isinstance(value, (int, float))
        or float(value or 0.0) <= 0.0
        or bool(parsed.get("watchdog_timeout"))
    )
    if "last_tpu_measurement" in parsed:
        rec["notes"].append(
            "carries cached last_tpu_measurement (degraded-run rider; the "
            "on-chip record is ingested from its own artifact)"
        )
        rider = parsed["last_tpu_measurement"]
        if isinstance(rider, dict):
            # surfaced for the claims engine: a claim satisfied ONLY by
            # this rider's numbers reads `stale`, never `claimed`
            rider_metrics = {}
            rm = rider.get("metric")
            if rm is not None and isinstance(
                    rider.get("value"), (int, float)):
                rider_metrics[rm] = float(rider["value"])
            for k, v in rider.items():
                if k.endswith(_RATE_SUFFIXES) and isinstance(
                        v, (int, float)) and not isinstance(v, bool):
                    rider_metrics[k] = float(v)
            stale_s = rider.get("stale_s")
            if stale_s is None and isinstance(
                    rider.get("age_hours"), (int, float)):
                stale_s = round(float(rider["age_hours"]) * 3600.0, 1)
            rec["context"]["embedded_tpu_rider"] = {
                "stale_s": stale_s,
                "metrics": rider_metrics,
            }


def _normalize_bench(source: str, doc: dict, chip: str = "tpu") -> dict:
    rec = _base_record(source, "bench")
    if "parsed" in doc or "rc" in doc:  # driver-wrapped round artifact
        rec["round"] = doc.get("n", rec["round"])
        rec["context"]["rc"] = doc.get("rc")
        parsed = doc.get("parsed")
        if parsed is None:
            rec["notes"].append(
                f"DNF: rc={doc.get('rc')} with no parseable metric line"
            )
            rec["fingerprint"] = fingerprint_key(None)
            return rec
        _normalize_bench_parsed(rec, parsed, chip)
        return rec
    _normalize_bench_parsed(rec, doc, chip)  # raw on-chip record
    return rec


def _normalize_soak(source: str, doc: dict, chip: str = "tpu") -> dict:
    rec = _base_record(source, "soak")
    thr = doc.get("throughput") or {}
    for k in ("sigs_per_s", "sigs_per_s_under_slo", "slo_hit_rate"):
        if isinstance(thr.get(k), (int, float)):
            rec["metrics"][k] = float(thr[k])
    if isinstance(thr.get("duration_s"), (int, float)):
        rec["context"]["duration_s"] = float(thr["duration_s"])
    out = doc.get("outcomes") or {}
    for k in ("submitted", "succeeded", "shed", "failed", "retries"):
        if isinstance(out.get(k), (int, float)):
            rec["context"][k] = out[k]
    lat = doc.get("latency_ms") or {}
    for lane, summ in sorted(lat.items()):
        if isinstance(summ, dict):
            for q in ("p50", "p99"):
                if isinstance(summ.get(q), (int, float)):
                    rec["metrics"][f"latency_{lane}_{q}_ms"] = float(summ[q])
    rec["context"]["accounting_ok"] = bool(doc.get("accounting_ok"))
    env = doc.get("env") if isinstance(doc.get("env"), dict) else None
    if env:
        rec["env"] = env
        rec["platform"] = str(env.get("platform") or "unknown")
    rec["fingerprint"] = fingerprint_key(env, platform_hint=rec["platform"])
    rec["degraded"] = rec["platform"] != chip
    if rec["degraded"]:
        rec["notes"].append(
            "host-platform soak (compile-dominated latencies) — not a chip "
            "serving number"
        )
    return rec


def _normalize_multichip(source: str, doc: dict) -> dict:
    rec = _base_record(source, "multichip")
    ok = bool(doc.get("ok"))
    rec["metrics"]["dryrun_ok"] = 1.0 if ok else 0.0
    rec["context"]["n_devices"] = doc.get("n_devices")
    rec["context"]["rc"] = doc.get("rc")
    rec["context"]["skipped"] = bool(doc.get("skipped"))
    rec["platform"] = "tpu" if ok else "unknown"
    rec["degraded"] = not ok
    if not ok:
        rec["notes"].append("dryrun failed or had no devices")
    rec["fingerprint"] = fingerprint_key(None, platform_hint=rec["platform"])
    return rec


def _normalize_pipeline(source: str, doc: dict, chip: str = "tpu") -> dict:
    """scripts/bench_pipeline_cpu.py A/B artifact: K-sweep idle
    fractions are the metrics; bit-identity and the collapse ratio are
    context."""
    rec = _base_record(source, "pipeline")
    for k, v in doc.items():
        if k.startswith("idle_fraction_k") and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            rec["metrics"][k] = float(v)
    for k in ("batch", "idle_collapse_ratio"):
        if isinstance(doc.get(k), (int, float)) \
                and not isinstance(doc.get(k), bool):
            rec["context"][k] = doc[k]
    rec["context"]["signatures_bit_identical"] = bool(
        doc.get("signatures_bit_identical"))
    rec["measured_at"] = doc.get("measured_at")
    env = doc.get("env") if isinstance(doc.get("env"), dict) else None
    if env:
        rec["env"] = env
        rec["platform"] = str(env.get("platform") or "unknown")
    rec["fingerprint"] = fingerprint_key(env, platform_hint=rec["platform"])
    rec["degraded"] = (
        rec["platform"] != chip
        or not doc.get("signatures_bit_identical")
    )
    if rec["platform"] != chip:
        rec["notes"].append(
            "host-platform pipeline A/B (scheduling proof only) — the "
            "chip idle collapse is a claims-ledger item"
        )
    return rec


def _normalize_campaign(source: str, doc: dict, chip: str = "tpu") -> dict:
    """perf/campaign.py report: metrics/context were already lifted by
    the runner; DNF steps become notes so the history shows exactly
    which part of a round died."""
    rec = _base_record(source, "campaign")
    for k, v in (doc.get("metrics") or {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            rec["metrics"][k] = float(v)
    ctx = doc.get("context")
    if isinstance(ctx, dict):
        rec["context"].update(ctx)
    rec["context"]["rehearse"] = bool(doc.get("rehearse"))
    rec["measured_at"] = doc.get("measured_at")
    for sid, res in sorted((doc.get("steps") or {}).items()):
        if isinstance(res, dict) and res.get("dnf"):
            note = f"step {sid} DNF: {res.get('reason') or 'no reason'}"
            if isinstance(res.get("elapsed_s"), (int, float)):
                note += f" after {res['elapsed_s']:.1f}s"
            rec["notes"].append(note)
    env = doc.get("env") if isinstance(doc.get("env"), dict) else None
    if env:
        rec["env"] = env
        rec["platform"] = str(env.get("platform") or "unknown")
    rec["fingerprint"] = fingerprint_key(env, platform_hint=rec["platform"])
    # a rehearsal is degraded BY DESIGN (it proves the harness, not the
    # numbers); a live campaign is degraded off-chip or when incomplete
    rec["degraded"] = (
        rec["platform"] != chip
        or bool(doc.get("rehearse"))
        or not doc.get("complete")
    )
    if doc.get("rehearse"):
        rec["notes"].append(
            "CPU rehearsal campaign — harness proof, numbers are not "
            "chip evidence"
        )
    return rec


def normalize(path: str) -> dict:
    """One committed artifact → one normalized history record. Raises
    on unreadable JSON — an artifact the ledger cannot parse is a gate
    failure, not a silent skip. A ``GPU_*`` artifact of the port takes the
    normalizer its name without the prefix names, with ``gpu`` as the
    chip platform; its ``source`` keeps the full name."""
    name = os.path.basename(path)
    with open(path) as f:
        doc = json.load(f)
    chip = "tpu"
    kind = name
    if name.startswith(GPU_PREFIX):
        chip, kind = "gpu", name[len(GPU_PREFIX):]
    if kind.startswith("SOAK_"):
        return _normalize_soak(name, doc, chip)
    if kind.startswith("MULTICHIP_"):
        return _normalize_multichip(name, doc)
    if kind.startswith("CAMPAIGN_"):
        return _normalize_campaign(name, doc, chip)
    if kind.startswith("BENCH_pipeline_"):
        return _normalize_pipeline(name, doc, chip)
    return _normalize_bench(name, doc, chip)


def build_history(root: str) -> List[dict]:
    """Every committed artifact, normalized and deterministically
    ordered (kind, round, source)."""
    records = [normalize(p) for p in discover_artifacts(root)]
    records.sort(key=lambda r: (r["kind"], r["round"] or 0, r["source"]))
    return records


def discover_gpu_artifacts(root: str) -> List[str]:
    """The port's artifacts at ``root`` (``GPU_ARTIFACT_GLOBS``)."""
    return sorted({p for pat in GPU_ARTIFACT_GLOBS for p in glob.glob(os.path.join(root, pat))})


def build_gpu_history(root: str) -> List[dict]:
    """The port's artifacts, normalized and ordered as
    :func:`build_history` orders JAX's; written as ``GPU_HISTORY_FILE``."""
    records = [normalize(p) for p in discover_gpu_artifacts(root)]
    records.sort(key=lambda r: (r["kind"], r["round"] or 0, r["source"]))
    return records


def write_history(records: List[dict], path: str) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


def load_history(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def group_by_fingerprint(records: List[dict]) -> Dict[str, List[dict]]:
    groups: Dict[str, List[dict]] = {}
    for rec in records:
        groups.setdefault(rec["fingerprint"] or "unknown/unstamped",
                          []).append(rec)
    return groups
