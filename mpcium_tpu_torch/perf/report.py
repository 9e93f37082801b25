"""Render the perf ledger: trend dashboard + Perfetto counter track.

The port's copy of the JAX package's ``perf/report.py``.
``render_dashboard`` turns the normalized history into the dashboard
markdown — per-metric trend tables with on-chip and degraded fingerprint
groups in separate tables, plus delta-vs-previous within each group.
``counter_track`` turns the same records into Chrome-trace ``C``
(counter) events that merge into a trace export via
``trace.export.chrome_trace(extra_events=...)``.

Everything here is a pure function of the records; the rendered text is
the JAX package's, byte for byte, so the committed dashboard stays one
document.
"""
from __future__ import annotations

from typing import Dict, List, Optional

# the trend columns of the flagship table, in narrative order
_BENCH_COLUMNS = (
    ("secp256k1_2of3_gg18_sigs_per_sec", "gg18 sigs/s"),
    ("gg18_ot_mta_sigs_per_sec", "OT-MtA sigs/s"),
    ("ed25519_2of3_sigs_per_sec", "ed25519 sigs/s"),
    ("ed25519_2of3_threshold_sigs_per_sec", "ed25519 sigs/s (r1 metric)"),
    ("secp256k1_dkg_wallets_per_sec", "DKG wallets/s"),
    ("reshare_2of3_to_3of5_wallets_per_sec", "reshare wallets/s"),
)

COUNTER_PID = "perf-ledger"


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "—"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    if abs(v) >= 10:
        return f"{v:.1f}"
    return f"{v:.3f}"


def _delta(cur: Optional[float], prev: Optional[float]) -> str:
    if cur is None or prev is None or prev == 0:
        return ""
    pct = (cur / prev - 1.0) * 100.0
    return f" ({pct:+.1f}%)"


def _bench_table(records: List[dict]) -> List[str]:
    cols = [c for c in _BENCH_COLUMNS
            if any(c[0] in r["metrics"] for r in records)]
    head = ("| source | round | fingerprint | mta | "
            + " | ".join(label for _k, label in cols)
            + " | compile_s | notes |")
    sep = "|" + "---|" * (len(cols) + 6)
    lines = [head, sep]
    # deltas compare like with like: same fingerprint group, same MtA
    # implementation (a paillier→ot jump is a config change, not a trend)
    prev: Dict[tuple, float] = {}
    for r in records:
        mta = str(r["context"].get("mta", "—"))
        cells = [r["source"], str(r["round"] if r["round"] is not None else "—"),
                 f"`{r['fingerprint']}`", mta]
        for key, _label in cols:
            v = r["metrics"].get(key)
            pk = (r["fingerprint"], mta, key)
            cells.append(_fmt(v) + _delta(v, prev.get(pk)))
            if v is not None:
                prev[pk] = v
        cells.append(_fmt(r["context"].get("compile_s")))
        cells.append("; ".join(r["notes"]) if r["notes"] else "")
        lines.append("| " + " | ".join(cells) + " |")
    return lines


def _soak_table(records: List[dict]) -> List[str]:
    lines = [
        "| source | fingerprint | sigs/s | sigs/s under SLO | SLO hit | "
        "p50 overall (ms) | p99 overall (ms) | accounting | notes |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        m = r["metrics"]
        lines.append(
            "| " + " | ".join([
                r["source"], f"`{r['fingerprint']}`",
                _fmt(m.get("sigs_per_s")),
                _fmt(m.get("sigs_per_s_under_slo")),
                _fmt(m.get("slo_hit_rate")),
                _fmt(m.get("latency_overall_p50_ms")),
                _fmt(m.get("latency_overall_p99_ms")),
                "closed" if r["context"].get("accounting_ok") else "OPEN",
                "; ".join(r["notes"]) if r["notes"] else "",
            ]) + " |"
        )
    return lines


def _multichip_table(records: List[dict]) -> List[str]:
    lines = ["| source | round | devices | dryrun | notes |",
             "|---|---|---|---|---|"]
    for r in records:
        ok = r["metrics"].get("dryrun_ok")
        lines.append("| " + " | ".join([
            r["source"], str(r["round"] if r["round"] is not None else "—"),
            str(r["context"].get("n_devices", "—")),
            "ok" if ok else "FAILED",
            "; ".join(r["notes"]) if r["notes"] else "",
        ]) + " |")
    return lines


def _pipeline_table(records: List[dict]) -> List[str]:
    lines = ["| source | batch | idle K=1 | idle K=2 | idle K=4 | "
             "bit-identical | platform |",
             "|---|---|---|---|---|---|---|"]
    for r in records:
        m = r["metrics"]
        lines.append("| " + " | ".join([
            r["source"], str(r["context"].get("batch", "—")),
            _fmt(m.get("idle_fraction_k1")), _fmt(m.get("idle_fraction_k2")),
            _fmt(m.get("idle_fraction_k4")),
            "yes" if r["context"].get("signatures_bit_identical") else "NO",
            r["platform"],
        ]) + " |")
    return lines


def _campaign_table(records: List[dict]) -> List[str]:
    lines = ["| source | mode | steps | DNF | flagship sigs/s | "
             "warm boot (s) | notes |",
             "|---|---|---|---|---|---|---|"]
    for r in records:
        m = r["metrics"]
        lines.append("| " + " | ".join([
            r["source"],
            "rehearsal" if r["context"].get("rehearse") else "live",
            f"{int(m.get('campaign_steps_done', 0))}/"
            f"{int(m.get('campaign_steps_total', 0))}",
            str(int(m.get("campaign_steps_dnf", 0))),
            _fmt(m.get("gg18_ot_mta_sigs_per_sec")
                 or m.get("secp256k1_2of3_gg18_sigs_per_sec")),
            _fmt(m.get("warmboot_first_sign_s")),
            "; ".join(r["notes"]) if r["notes"] else "",
        ]) + " |")
    return lines


def _claims_section(records: List[dict]) -> List[str]:
    from . import claims

    evaluated = claims.evaluate(records)
    s = claims.summary(evaluated)
    lines = [
        f"Every ROADMAP-owed headline as a machine-evaluated claim "
        f"(`mpcium_tpu/perf/claims.py`; full ledger in `CLAIMS.md`): "
        f"**{s['claimed']} claimed · {s['owed']} owed · "
        f"{s['stale']} stale.**",
        "",
        "| claim | class | status | evidence |",
        "|---|---|---|---|",
    ]
    for c in evaluated:
        ev = ""
        if c["evidence"]:
            ev = f"`{c['evidence']['source']}` → {c['evidence']['value']}"
        lines.append(
            f"| {c['id']} | {c['envfp_class']} | {c['status']} | {ev} |"
        )
    return lines


def render_dashboard(records: List[dict],
                     micro_baseline: Optional[dict] = None) -> str:
    """The committed dashboard, deterministic from its inputs."""
    by_kind: Dict[str, List[dict]] = {"bench": [], "soak": [], "multichip": []}
    for r in records:
        by_kind.setdefault(r["kind"], []).append(r)

    out: List[str] = [
        "# Performance dashboard",
        "",
        "Generated by `scripts/perfcheck.py --regen-history` from the",
        "committed `BENCH_*` / `SOAK_*` / `MULTICHIP_*` artifacts — do not",
        "edit by hand; CI gates this file against a regeneration. Records",
        "are grouped by env fingerprint (`mpcium_tpu/perf/envfp.py`):",
        "**degraded runs (CPU fallback, watchdog zero-records, DNFs) are",
        "tabled separately and never enter a chip trend.** Deltas compare",
        "against the previous row of the same table.",
        "",
    ]

    bench = by_kind["bench"]
    chip = [r for r in bench if not r["degraded"]]
    degraded = [r for r in bench if r["degraded"]]
    out += ["## Flagship trajectory — on-chip", ""]
    if chip:
        out += _bench_table(chip)
    else:
        out.append("(no on-chip records yet)")
    out += ["", "## Bench rounds — degraded / DNF (not comparable to chip)",
            ""]
    if degraded:
        out += _bench_table(degraded)
    else:
        out.append("(none)")

    out += ["", "## Soak (serving under SLO)", ""]
    out += _soak_table(by_kind["soak"]) if by_kind["soak"] else ["(none)"]

    out += ["", "## Multichip dryruns", ""]
    out += (_multichip_table(by_kind["multichip"])
            if by_kind["multichip"] else ["(none)"])

    pipeline = by_kind.get("pipeline") or []
    out += ["", "## Pipeline idle A/B (counter-phase cohorts)", ""]
    out += _pipeline_table(pipeline) if pipeline else ["(none)"]

    campaigns = by_kind.get("campaign") or []
    out += ["", "## Campaigns (scripts/tpu_round.py)", ""]
    out += _campaign_table(campaigns) if campaigns else ["(none)"]

    out += ["", "## Claims ledger", ""]
    out += _claims_section(records)

    if micro_baseline:
        out += ["", "## Micro-baselines (perfcheck gate)", "",
                f"Committed for host `{micro_baseline.get('host', '?')}`, "
                f"python {micro_baseline.get('python', '?')}; the gate "
                "re-anchors informationally on foreign hosts.", "",
                "| bench | baseline median (ms) | samples |",
                "|---|---|---|"]
        from .statcheck import median

        for name, b in sorted((micro_baseline.get("benches") or {}).items()):
            samples = b.get("samples") or []
            med = median(samples) * 1e3 if samples else None
            out.append(f"| {name} | {_fmt(med)} | {len(samples)} |")
    out.append("")
    return "\n".join(out)


def counter_track(records: List[dict]) -> List[dict]:
    """Chrome-trace counter events for the bench trajectory: one ``C``
    event per (record, metric), ts = round index in seconds, on a
    dedicated ``perf-ledger`` pid with its own process_name metadata.
    Merge with ``trace.export.chrome_trace(..., extra_events=...)``."""
    events: List[dict] = [{
        "ph": "M", "name": "process_name", "pid": COUNTER_PID, "tid": 0,
        "args": {"name": "perf ledger (bench trajectory)"},
    }]
    bench = [r for r in records if r["kind"] == "bench" and not r["degraded"]]
    for i, rec in enumerate(bench):
        ts_us = float(i) * 1e6  # one "second" per record: a trend axis,
        for key, _label in _BENCH_COLUMNS:  # not a wall-clock claim
            v = rec["metrics"].get(key)
            if v is None:
                continue
            events.append({
                "ph": "C", "name": f"bench:{key}", "pid": COUNTER_PID,
                "tid": "trend", "ts": ts_us, "args": {"value": v},
            })
    return events
