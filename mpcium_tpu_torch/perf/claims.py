"""mpcclaims: the claims ledger — every owed headline number as code.

The port's copy of the JAX package's ``perf/claims.py``: the registry of
claims (``{"id", "title", "metric", "predicate", "artifact_kind",
"envfp_class", "roadmap"}``), the verdict engine that evaluates it
against the normalized artifact corpus (``perf/ledger.build_history``)
into ``owed`` / ``claimed`` / ``stale``, the two renders
(``CLAIMS.json``, ``CLAIMS.md``: the committed files, byte for byte),
the drift check, and the counts a daemon's health carries
(:func:`gauge_summary`, :func:`export_gauges`).

Two structural rules, as in the JAX package: a ``chip`` claim is only
satisfiable by a non-degraded record of the platform it names, and a
claim whose predicate holds only on an embedded stale rider reads
``stale``, never ``claimed``.

Stdlib only: the health surface polls ``gauge_summary()`` at human
cadence.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

CLAIMS_JSON = "CLAIMS.json"
CLAIMS_MD = "CLAIMS.md"

# -- metric addressing -------------------------------------------------------
#
# A claim's "metric" is one of:
#   <name>          -> record["metrics"][name]          (a rate/number)
#   ctx:<key>       -> record["context"][key]           (numeric context)
#   derived:<name>  -> computed from the record by _DERIVED[name]
#
# The vocabulary below is the drift gate's "0 unknown metrics" check:
# a claim referencing a metric outside it (and outside the corpus) is a
# typo that would sit "owed" forever without anyone noticing.

_PRIMARY_PHASES = (
    "r1_commit_encrypt_rangeproof",
    "r2_mta_ot",
    "r2_mta_respond",
    "r3_verify_decrypt",
    "r4_R_reconstruct_pok",
    "r5_phase5_combine_verify",
)


def _derived_r2_mta_ot_phase_share(record: dict) -> Optional[float]:
    """r2_mta_ot's share of the five primary GG18 round phases, from
    the OT-variant phase table when present (a paillier-flagship run
    records the OT pass under gg18_ot_mta_phase_s), else phase_s."""
    ctx = record.get("context") or {}
    table = ctx.get("gg18_ot_mta_phase_s") or ctx.get("phase_s") or {}
    if not isinstance(table, dict) or "r2_mta_ot" not in table:
        return None
    total = sum(
        float(table[k]) for k in _PRIMARY_PHASES
        if isinstance(table.get(k), (int, float))
    )
    if total <= 0:
        return None
    return float(table["r2_mta_ot"]) / total


_DERIVED = {
    "r2_mta_ot_phase_share": _derived_r2_mta_ot_phase_share,
}

KNOWN_METRICS = frozenset({
    # bench.py flagship + secondary emission
    "secp256k1_2of3_gg18_sigs_per_sec",
    "gg18_ot_mta_sigs_per_sec",
    "ed25519_2of3_sigs_per_sec",
    "ed25519_2of3_threshold_sigs_per_sec",
    "secp256k1_dkg_wallets_per_sec",
    "reshare_2of3_to_3of5_wallets_per_sec",
    "b_sweep_1024_sigs_per_sec",
    "b_sweep_4096_sigs_per_sec",
    "b_sweep_8192_sigs_per_sec",
    "b_sweep_16384_sigs_per_sec",
    # pipeline A/B artifacts (scripts/bench_pipeline_cpu.py)
    "idle_fraction_k1",
    "idle_fraction_k2",
    "idle_fraction_k4",
    # campaign reports (perf/campaign.py)
    "campaign_complete",
    "campaign_steps_done",
    "campaign_steps_total",
    "campaign_steps_dnf",
    "warmboot_first_sign_s",
    "warmboot_cache_misses",
    "warmboot_cache_hits",
    "ot_host_extension_stage_speedup",
    "ot_device_stage_speedup",
})

KNOWN_CONTEXT = frozenset({
    "gg18_ot_checks_s",
    "gg18_ot_checks_on_s",
    "gg18_ot_checks_off_s",
    "gg18_ot_mta_device_s",
    "device_idle_fraction",
    "compile_unpredicted",
    "compile_count",
})


def record_value(record: dict, metric: str) -> Optional[float]:
    """Resolve a claim metric against one normalized history record;
    None when the record does not carry it."""
    if metric.startswith("derived:"):
        fn = _DERIVED.get(metric[len("derived:"):])
        return fn(record) if fn else None
    if metric.startswith("ctx:"):
        v = (record.get("context") or {}).get(metric[len("ctx:"):])
    else:
        v = (record.get("metrics") or {}).get(metric)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


# -- predicate DSL -----------------------------------------------------------

_OPS = {
    "gt": lambda v, t: v > t,
    "ge": lambda v, t: v >= t,
    "lt": lambda v, t: v < t,
    "le": lambda v, t: v <= t,
    "eq": lambda v, t: v == t,
}


def eval_predicate(predicate: dict, record: dict,
                   value: Optional[float]) -> bool:
    """Machine-evaluate one predicate against a resolved metric value.
    ``exists`` passes on any resolved value; ``lt_metric``/``gt_metric``
    compare against a second metric of the SAME record (the K=2-beats-
    K=1 shape). Unresolvable values never satisfy anything."""
    if value is None:
        return False
    op = predicate.get("op")
    if op == "exists":
        return True
    if op in ("lt_metric", "gt_metric"):
        other = record_value(record, str(predicate.get("metric")))
        if other is None:
            return False
        return value < other if op == "lt_metric" else value > other
    fn = _OPS.get(op)
    if fn is None:
        raise ValueError(f"unknown predicate op {op!r}")
    return fn(value, float(predicate["value"]))


def render_predicate(predicate: dict) -> str:
    op = predicate.get("op")
    if op == "exists":
        return "recorded"
    if op in ("lt_metric", "gt_metric"):
        sym = "<" if op == "lt_metric" else ">"
        return f"{sym} {predicate.get('metric')}"
    sym = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "="}[op]
    return f"{sym} {predicate['value']}"


# -- the registry ------------------------------------------------------------
#
# One entry per headline number the ROADMAP owes. "requires" are extra
# per-record numeric gates (same metric grammar) that qualify WHICH
# records may testify — e.g. the phase-share claim only counts runs
# whose trace actually carried device=True OT spans.

REGISTRY: List[dict] = [
    {
        "id": "flagship-ot-checks-on",
        "title": "OT-MtA flagship, active checks ON, beats the 72.1 headline",
        "metric": "gg18_ot_mta_sigs_per_sec",
        "predicate": {"op": "gt", "value": 72.1},
        "requires": [{"metric": "ctx:gg18_ot_checks_on_s",
                      "op": "gt", "value": 0.0}],
        "artifact_kind": ["bench", "campaign"],
        "envfp_class": "chip",
        "roadmap": "item 1+2 — the new headline; checks on by default "
                   "since PR 16, never yet run on a chip",
    },
    {
        "id": "r2-mta-ot-phase-share",
        "title": "r2_mta_ot phase share < 45% with device OT spans",
        "metric": "derived:r2_mta_ot_phase_share",
        "predicate": {"op": "lt", "value": 0.45},
        "requires": [{"metric": "ctx:gg18_ot_mta_device_s",
                      "op": "gt", "value": 0.0}],
        "artifact_kind": ["bench", "campaign"],
        "envfp_class": "chip",
        "roadmap": "item 1 — device OT kernels (PR 10) shrink the host "
                   "wall; pre-device artifact sits at 45.4%",
    },
    {
        "id": "ot-checks-delta",
        "title": "checks-on/off delta (gg18_ot_checks_s) measured on chip",
        "metric": "ctx:gg18_ot_checks_s",
        "predicate": {"op": "exists"},
        "artifact_kind": ["bench", "campaign"],
        "envfp_class": "chip",
        "roadmap": "item 2 — the overhead contract of the PR 16 active-"
                   "security checks (bench.py already records it)",
    },
    {
        "id": "ed25519-10k",
        "title": "ed25519 with device SHA-512 at >= 10k sigs/s",
        "metric": "ed25519_2of3_sigs_per_sec",
        "predicate": {"op": "ge", "value": 10000.0},
        "artifact_kind": ["bench", "campaign"],
        "envfp_class": "chip",
        "roadmap": "item 1 — north-star scheme target; last on-chip "
                   "number (3,125) predates the device hash suite",
    },
    {
        "id": "b-sweep-16384",
        "title": "b_sweep completes the 16384 bucket on chip",
        "metric": "b_sweep_16384_sigs_per_sec",
        "predicate": {"op": "gt", "value": 0.0},
        "artifact_kind": ["bench", "campaign"],
        "envfp_class": "chip",
        "roadmap": "item 1+4 — the ISSUE 17 bucket; B=8192 DNF'd "
                   "pre-device-OT",
    },
    {
        "id": "pipeline-idle-collapse",
        "title": "counter-phase pipeline: K=2 idle fraction below K=1 "
                 "at equal B, on chip",
        "metric": "idle_fraction_k2",
        "predicate": {"op": "lt_metric", "metric": "idle_fraction_k1"},
        "artifact_kind": ["pipeline", "campaign"],
        "envfp_class": "chip",
        "roadmap": "item 4 — the zero-idle meter (ISSUE 17), CPU A/B "
                   "committed, chip collapse owed",
    },
    {
        "id": "warm-cold-boot-60s",
        "title": "cold boot against a prewarmed cache: first signature "
                 "< 60 s, zero cache misses",
        "metric": "warmboot_first_sign_s",
        "predicate": {"op": "lt", "value": 60.0},
        "requires": [{"metric": "warmboot_cache_misses",
                      "op": "eq", "value": 0.0}],
        "artifact_kind": ["campaign"],
        "envfp_class": "chip",
        "roadmap": "item 1 — the mpcwarm (PR 12) proof vs the 802-1,401 s "
                   "compile wall",
    },
    {
        "id": "predicted-true-ledger",
        "title": "every compile in the round was statically predicted",
        "metric": "ctx:compile_unpredicted",
        "predicate": {"op": "eq", "value": 0.0},
        "requires": [{"metric": "ctx:compile_count",
                      "op": "gt", "value": 0.0}],
        "artifact_kind": ["bench", "campaign"],
        "envfp_class": "chip",
        "roadmap": "item 1 — `predicted: true` across the board "
                   "(mpcshape surface, PR 11)",
    },
    # -- rehearsal class: the harness itself, provable on any host ----------
    {
        "id": "campaign-rehearsal-complete",
        "title": "the full campaign step DAG runs end-to-end on CPU",
        "metric": "campaign_complete",
        "predicate": {"op": "eq", "value": 1.0},
        "artifact_kind": ["campaign"],
        "envfp_class": "rehearsal",
        "roadmap": "item 1 — scripts/tpu_round.py --rehearse: same DAG, "
                   "same state machine, same verdict path as the live "
                   "window",
    },
    {
        "id": "pipeline-idle-collapse-rehearsal",
        "title": "pipeline K=2 idle fraction below K=1 (CPU A/B proof)",
        "metric": "idle_fraction_k2",
        "predicate": {"op": "lt_metric", "metric": "idle_fraction_k1"},
        "artifact_kind": ["pipeline", "campaign"],
        "envfp_class": "rehearsal",
        "roadmap": "item 4 — BENCH_pipeline_cpu.json (ISSUE 17)",
    },
]

# the ROADMAP item-1 owed matrix: every headline metric here must be
# covered by at least one registry claim, or the drift gate fails —
# "silently untracked" is the state this file exists to abolish
ROADMAP_HEADLINES: Dict[str, str] = {
    "gg18_ot_mta_sigs_per_sec": "flagship OT sigs/s (replaces 72.1)",
    "derived:r2_mta_ot_phase_share": "r2_mta_ot share < 45%, device spans",
    "ctx:gg18_ot_checks_s": "checks-on/off delta",
    "ed25519_2of3_sigs_per_sec": "ed25519 >= 10k sigs/s",
    "b_sweep_16384_sigs_per_sec": "b_sweep through 16384",
    "idle_fraction_k2": "pipeline idle K=2 < K=1 at equal B",
    "warmboot_first_sign_s": "warm cold-boot first signature < 60 s",
    "ctx:compile_unpredicted": "`predicted: true` across the ledger",
}


# -- the verdict engine ------------------------------------------------------


def _meets_requires(claim: dict, record: dict) -> bool:
    for req in claim.get("requires", ()):  # all must hold on the record
        v = record_value(record, req["metric"])
        if v is None or not _OPS[req["op"]](v, float(req["value"])):
            return False
    return True


def _eligible(claim: dict, record: dict) -> bool:
    if record.get("kind") not in claim["artifact_kind"]:
        return False
    if claim["envfp_class"] == "chip":
        # the structural r05 fix: degraded/CPU records can testify only
        # for rehearsal claims, no matter what numbers they carry
        return (not record.get("degraded")
                and record.get("platform") == "tpu")
    return True


def _rider_of(record: dict) -> Optional[dict]:
    rider = (record.get("context") or {}).get("embedded_tpu_rider")
    return rider if isinstance(rider, dict) else None


def _evidence(record: dict, value: float) -> dict:
    return {
        "source": record.get("source"),
        "fingerprint": record.get("fingerprint"),
        "value": round(value, 6),
        "measured_at": record.get("measured_at"),
    }


def evaluate(records: Sequence[dict]) -> List[dict]:
    """Verdict pass: one evaluated claim per registry entry, in registry
    order — a pure function of (REGISTRY, records), no clock, no host
    facts, so the committed CLAIMS.json/CLAIMS.md are drift-gateable."""
    out = []
    for claim in REGISTRY:
        satisfied = None
        for rec in records:
            if not _eligible(claim, rec) or not _meets_requires(claim, rec):
                continue
            v = record_value(rec, claim["metric"])
            if eval_predicate(claim["predicate"], rec, v):
                satisfied = _evidence(rec, v)  # last (newest) wins
        status, evidence = "owed", None
        if satisfied is not None:
            status, evidence = "claimed", satisfied
        elif claim["envfp_class"] == "chip":
            # stale check: does the predicate hold only on an embedded
            # last_tpu_measurement rider some degraded run carried?
            for rec in records:
                rider = _rider_of(rec)
                if rider is None:
                    continue
                shim = {"metrics": rider.get("metrics") or {},
                        "context": {}}
                v = record_value(shim, claim["metric"])
                if not claim.get("requires") and eval_predicate(
                        claim["predicate"], shim, v):
                    status = "stale"
                    evidence = {
                        "source": rec.get("source"),
                        "fingerprint": rec.get("fingerprint"),
                        "value": round(v, 6),
                        "stale_s": rider.get("stale_s"),
                        "note": "embedded last_tpu_measurement rider — "
                                "predates the code under test",
                    }
        out.append({
            "id": claim["id"],
            "title": claim["title"],
            "metric": claim["metric"],
            "predicate": claim["predicate"],
            "artifact_kind": list(claim["artifact_kind"]),
            "envfp_class": claim["envfp_class"],
            "requires": list(claim.get("requires", [])),
            "roadmap": claim["roadmap"],
            "status": status,
            "evidence": evidence,
        })
    return out


def summary(evaluated: Sequence[dict]) -> Dict[str, int]:
    counts = {"owed": 0, "claimed": 0, "stale": 0}
    for c in evaluated:
        counts[c["status"]] = counts.get(c["status"], 0) + 1
    return counts


# -- renderers (both committed, both drift-gated) ----------------------------


def render_json(evaluated: Sequence[dict]) -> str:
    doc = {
        "_comment": (
            "Evaluated claims ledger — generated by scripts/claimscheck.py "
            "--regen from mpcium_tpu/perf/claims.REGISTRY x the committed "
            "perf artifacts. Do not edit by hand; CI byte-gates this file."
        ),
        "summary": summary(evaluated),
        "claims": list(evaluated),
    }
    return json.dumps(doc, indent=1, sort_keys=True) + "\n"


def render_md(evaluated: Sequence[dict]) -> str:
    s = summary(evaluated)
    lines = [
        "# Claims ledger",
        "",
        "Every headline number the ROADMAP owes, as a machine-evaluated",
        "claim. Generated by `scripts/claimscheck.py --regen` from",
        "`mpcium_tpu/perf/claims.py` × the committed perf artifacts — do",
        "not edit by hand; `make claimscheck` byte-gates this file.",
        "",
        f"**{s['claimed']} claimed · {s['owed']} owed · {s['stale']} "
        f"stale.** `owed` = no eligible artifact satisfies the predicate",
        "yet (the TPU campaign — `scripts/tpu_round.py` — is the single",
        "entry point that converts these). `chip` claims accept only",
        "non-degraded on-chip records; a claim satisfied only by an",
        "embedded stale `last_tpu_measurement` rider reads `stale`,",
        "never `claimed`.",
        "",
        "| claim | class | predicate | status | evidence |",
        "|---|---|---|---|---|",
    ]
    for c in evaluated:
        pred = f"`{c['metric']}` {render_predicate(c['predicate'])}"
        for req in c["requires"]:
            pred += (f"; `{req['metric']}` "
                     f"{render_predicate({k: req[k] for k in ('op', 'value')})}")
        ev = ""
        if c["evidence"]:
            e = c["evidence"]
            ev = f"`{e['source']}` → {e['value']}"
            if e.get("stale_s") is not None:
                ev += f" (stale {e['stale_s']:.0f}s rider)"
        status = {"claimed": "**claimed**", "owed": "owed",
                  "stale": "STALE"}[c["status"]]
        lines.append(
            f"| {c['id']} — {c['title']} | {c['envfp_class']} | {pred} "
            f"| {status} | {ev} |"
        )
    lines += [
        "",
        "Provenance (ROADMAP pointers):",
        "",
    ]
    for c in evaluated:
        lines.append(f"- **{c['id']}**: {c['roadmap']}")
    lines.append("")
    return "\n".join(lines)


# -- the drift gate ----------------------------------------------------------


def registry_problems(records: Sequence[dict]) -> List[str]:
    """Registry hygiene: 0 unknown metrics (typo'd claims would sit owed
    forever) and 0 silently-untracked ROADMAP headline numbers."""
    problems = []
    corpus = set()
    for rec in records:
        corpus.update((rec.get("metrics") or {}).keys())
    seen_ids = set()
    claimed_metrics = set()
    for claim in REGISTRY:
        if claim["id"] in seen_ids:
            problems.append(f"duplicate claim id {claim['id']!r}")
        seen_ids.add(claim["id"])
        refs = [claim["metric"]]
        refs += [r["metric"] for r in claim.get("requires", ())]
        if claim["predicate"].get("op") in ("lt_metric", "gt_metric"):
            refs.append(claim["predicate"]["metric"])
        claimed_metrics.update(refs)
        for m in refs:
            if m.startswith("derived:"):
                known = m[len("derived:"):] in _DERIVED
            elif m.startswith("ctx:"):
                known = m[len("ctx:"):] in KNOWN_CONTEXT
            else:
                known = m in KNOWN_METRICS or m in corpus
            if not known:
                problems.append(
                    f"claim {claim['id']!r}: unknown metric {m!r} — not in "
                    f"the claims vocabulary nor the artifact corpus"
                )
    for metric, label in sorted(ROADMAP_HEADLINES.items()):
        if metric not in claimed_metrics:
            problems.append(
                f"ROADMAP headline {label!r} ({metric}) has no claim "
                f"tracking it — silently-untracked measurement debt"
            )
    return problems


def check_problems(root: str, records: Optional[Sequence[dict]] = None
                   ) -> List[str]:
    """The full claimscheck: registry hygiene + byte drift of the two
    committed renders. Empty list = green."""
    if records is None:
        from . import ledger

        records = ledger.build_history(root)
    problems = registry_problems(records)
    evaluated = evaluate(records)
    for basename, text in ((CLAIMS_JSON, render_json(evaluated)),
                           (CLAIMS_MD, render_md(evaluated))):
        path = os.path.join(root, basename)
        try:
            with open(path) as f:
                committed = f.read()
        except OSError:
            problems.append(
                f"{basename} missing — run scripts/claimscheck.py --regen"
            )
            continue
        if committed != text:
            problems.append(
                f"{basename} does not match the artifact corpus — "
                f"regenerate with scripts/claimscheck.py --regen and "
                f"review the diff"
            )
    return problems


# -- daemon health surface ---------------------------------------------------

_gauge_lock = threading.Lock()
_gauge_cache: dict = {"at": 0.0, "root": None, "counts": None}


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def gauge_summary(root: Optional[str] = None,
                  max_age_s: float = 60.0) -> Dict[str, int]:
    """owed/claimed/stale counts for the daemon health beat, cached at
    human cadence (the corpus is a dozen small JSON files; re-reading it
    every 10 s health tick is pointless). Never raises — an unreadable
    corpus reads as all-zero measurement debt plus an ``error`` flag."""
    root = root or _repo_root()
    now = time.monotonic()
    with _gauge_lock:
        if (_gauge_cache["counts"] is not None
                and _gauge_cache["root"] == root
                and now - _gauge_cache["at"] < max_age_s):
            return dict(_gauge_cache["counts"])
    try:
        from . import ledger

        counts = summary(evaluate(ledger.build_history(root)))
    except Exception:  # noqa: BLE001 — health must never die on claims
        counts = {"owed": 0, "claimed": 0, "stale": 0, "error": 1}
    with _gauge_lock:
        _gauge_cache.update({"at": now, "root": root, "counts": counts})
    return dict(counts)


def export_gauges(metrics, root: Optional[str] = None) -> Dict[str, int]:
    """Mirror the claim counts into a MetricsRegistry so the ``.prom``
    health sidecar shows measurement debt next to compile-watch state."""
    counts = gauge_summary(root)
    for key in ("owed", "claimed", "stale"):
        metrics.gauge(f"claims.{key}").set(float(counts.get(key, 0)))
    return counts


def reset_gauge_cache() -> None:
    """Test hook."""
    with _gauge_lock:
        _gauge_cache.update({"at": 0.0, "root": None, "counts": None})
