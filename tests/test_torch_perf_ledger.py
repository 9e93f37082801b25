"""The port's perf ledger, dashboard and claims against the JAX package's:
``perf/ledger.py`` normalizes the committed artifacts record for record
as JAX does and rewrites the committed ``PERF_history.jsonl`` byte for
byte, ``perf/report.py`` renders the same dashboard and counter track,
``perf/claims.py`` renders the committed ``CLAIMS.json`` and
``CLAIMS.md`` byte for byte with the same gauges, and a port node's
``EventConsumer.health()`` carries the claims section and gauges."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from mpcium_tpu.perf import claims as jclaims
from mpcium_tpu.perf import ledger as jledger
from mpcium_tpu.perf import report as jreport
from mpcium_tpu.utils.metrics import MetricsRegistry as JaxMetrics

from mpcium_tpu_torch.perf import claims, ledger, report
from mpcium_tpu_torch.utils.metrics import MetricsRegistry

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def records():
    return ledger.build_history(str(ROOT))


@pytest.fixture(autouse=True)
def _fresh_gauges():
    claims.reset_gauge_cache()
    jclaims.reset_gauge_cache()
    yield
    claims.reset_gauge_cache()
    jclaims.reset_gauge_cache()


def test_ledger_discovers_and_normalizes_as_jax(records):
    assert ledger.ARTIFACT_GLOBS == jledger.ARTIFACT_GLOBS
    assert ledger.discover_artifacts(str(ROOT)) == jledger.discover_artifacts(str(ROOT))
    want = jledger.build_history(str(ROOT))
    assert len(records) == len(want) > 0
    for got, exp in zip(records, want):
        assert got == exp, got["source"]
    assert ledger.group_by_fingerprint(records) == jledger.group_by_fingerprint(want)


def test_write_history_reproduces_the_committed_history(records, tmp_path):
    out = tmp_path / "PERF_history.jsonl"
    ledger.write_history(records, str(out))
    assert out.read_bytes() == (ROOT / ledger.HISTORY_FILE).read_bytes()
    assert ledger.load_history(str(out)) == records


def test_port_artifacts_stay_out_of_the_ledger(tmp_path):
    (tmp_path / "GPU_BENCH_x.json").write_text("{}")
    (tmp_path / "GPU_SOAK_x.json").write_text("{}")
    (tmp_path / "BENCH_r07.json").write_text(json.dumps({"n": 7, "rc": 1, "parsed": None}))
    names = [Path(p).name for p in ledger.discover_artifacts(str(tmp_path))]
    assert names == ["BENCH_r07.json"]
    rec = ledger.build_history(str(tmp_path))[0]
    assert rec == jledger.build_history(str(tmp_path))[0]
    assert rec["degraded"] and rec["fingerprint"] == "unknown/unstamped"


@pytest.mark.parametrize("with_baseline", [False, True])
def test_dashboard_and_counter_track_equal_jax(records, with_baseline):
    baseline = (json.loads((ROOT / "PERF_baseline_micro.json").read_text())
                if with_baseline else None)
    got = report.render_dashboard(records, micro_baseline=baseline)
    assert got == jreport.render_dashboard(records, micro_baseline=baseline)
    if with_baseline:
        assert got == (ROOT / "PERFORMANCE_dashboard.md").read_text()
    assert report.counter_track(records) == jreport.counter_track(records)


def test_claims_render_the_committed_files(records):
    evaluated = claims.evaluate(records)
    assert evaluated == jclaims.evaluate(records)
    assert claims.render_json(evaluated) == (ROOT / claims.CLAIMS_JSON).read_text()
    assert claims.render_md(evaluated) == (ROOT / claims.CLAIMS_MD).read_text()
    assert claims.registry_problems(records) == jclaims.registry_problems(records) == []
    assert claims.check_problems(str(ROOT)) == []


def test_gauge_summary_and_export_equal_jax(tmp_path):
    assert claims._repo_root() == str(ROOT)
    got = claims.gauge_summary()
    assert got == jclaims.gauge_summary(str(ROOT))
    assert sum(got.values()) == len(claims.REGISTRY)
    m, jm = MetricsRegistry(), JaxMetrics()
    assert claims.export_gauges(m) == jclaims.export_gauges(jm, str(ROOT))
    for key in ("owed", "claimed", "stale"):
        assert m.gauge(f"claims.{key}").value == jm.gauge(f"claims.{key}").value
    bad = tmp_path / "corpus"
    bad.mkdir()
    (bad / "BENCH_r99.json").write_text("{not json")
    claims.reset_gauge_cache()
    assert claims.gauge_summary(str(bad)) == {"owed": 0, "claimed": 0, "stale": 0, "error": 1}


def test_node_health_carries_the_claims_section(tmp_path):
    from mpcium_tpu_torch.cluster import LocalCluster

    want = jclaims.gauge_summary(str(ROOT))
    cluster = LocalCluster(n_nodes=2, threshold=1, root_dir=str(tmp_path), device="cpu")
    try:
        health = cluster.health()
    finally:
        cluster.close()
    assert sorted(health) == ["node0", "node1"]
    for h in health.values():
        assert h["claims"] == want
        gauges = h["metrics"]["gauges"]
        for key in ("owed", "claimed", "stale"):
            assert gauges[f"claims.{key}"] == float(want[key])


# -- the port's own history: GPU_BENCH_* and GPU_CAMPAIGN_r* ------------------------

_GPU_ENV = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1,
            "host": "abc123", "torch": "2.11.0+cu128", "cuda": "12.8"}


def _gpu_artifacts(root: Path) -> None:
    bench = {"metric": "secp256k1_2of3_gg18_sigs_per_sec", "value": 30.5,
             "platform": "gpu", "batch": 1024, "runs": 1, "mta": "paillier",
             "device_idle_fraction": 0.01, "phase_s": {"r1": 2.0},
             "ed25519_2of3_sigs_per_sec": 3000.0,
             "b_sweep": {"1024": 30.5, "16384": {"dnf": True, "reason": "timeout",
                                                 "elapsed_s": 660.0, "env": _GPU_ENV}},
             "compile": {"compiles": 1, "cache_hits": 1}, "k0": {"launches": 378},
             "env": _GPU_ENV, "measured_at": "2026-10-18T15:00:00"}
    (root / "GPU_BENCH_flagship.json").write_text(json.dumps(bench))
    (root / "GPU_BENCH_pipeline_ab.json").write_text(json.dumps(
        {"batch": 4096, "idle_fraction_k1": 0.5, "idle_fraction_k2": 0.25,
         "signatures_bit_identical": True, "env": _GPU_ENV}))
    campaign = {"campaign": "gpu-round", "rehearse": False, "complete": True,
                "metrics": {"secp256k1_2of3_gg18_sigs_per_sec": 30.5, "campaign_complete": 1.0},
                "context": {"gg18_ot_checks_s": 1.5},
                "steps": {"flagship": {"metric": "m", "value": 30.5},
                          "warm_boot": {"dnf": True, "reason": "rc=1", "elapsed_s": 3.0}},
                "env": _GPU_ENV, "measured_at": "2026-10-18T16:00:00"}
    (root / "GPU_CAMPAIGN_r01.json").write_text(json.dumps(campaign))
    (root / "GPU_CAMPAIGN_state.json").write_text("{}")
    (root / "GPU_SOAK_x.json").write_text("{}")


def test_gpu_artifacts_normalize_into_the_ports_history(tmp_path):
    _gpu_artifacts(tmp_path)
    (tmp_path / "BENCH_r07.json").write_text(json.dumps({"n": 7, "rc": 1, "parsed": None}))
    names = [Path(p).name for p in ledger.discover_gpu_artifacts(str(tmp_path))]
    assert names == ["GPU_BENCH_flagship.json", "GPU_BENCH_pipeline_ab.json",
                     "GPU_CAMPAIGN_r01.json"]
    recs = ledger.build_gpu_history(str(tmp_path))
    assert [(r["kind"], r["source"]) for r in recs] == [
        ("bench", "GPU_BENCH_flagship.json"), ("campaign", "GPU_CAMPAIGN_r01.json"),
        ("pipeline", "GPU_BENCH_pipeline_ab.json")]
    bench, camp, pipe = recs
    assert bench["platform"] == "gpu" and not bench["degraded"]
    assert bench["fingerprint"] == "gpu/abc123/1xNVIDIA H100 80GB HBM3"
    assert bench["metrics"]["b_sweep_1024_sigs_per_sec"] == 30.5
    assert bench["context"]["b_sweep"]["16384"] == {"dnf": True}
    assert any("B=16384 DNF: timeout after 660.0s" in n for n in bench["notes"])
    assert camp["round"] == 1 and camp["degraded"] is False
    assert camp["notes"] == ["step warm_boot DNF: rc=1 after 3.0s"]
    assert pipe["metrics"] == {"idle_fraction_k1": 0.5, "idle_fraction_k2": 0.25}
    assert not pipe["degraded"]
    # through JAX's normalizers the same bytes are off-chip (its chip is the TPU)
    jrec = jledger.normalize(str(tmp_path / "GPU_BENCH_flagship.json"))
    assert jrec["degraded"] and {k: v for k, v in jrec.items() if k != "degraded"} == \
        {k: v for k, v in bench.items() if k != "degraded"}
    # neither JAX's history nor the port's copy of it reads a GPU artifact
    assert [Path(p).name for p in ledger.discover_artifacts(str(tmp_path))] == ["BENCH_r07.json"]
    assert ledger.build_history(str(tmp_path)) == jledger.build_history(str(tmp_path))


def test_round_ingest_writes_only_the_ports_history(tmp_path, records):
    import importlib.util

    _gpu_artifacts(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "torch_gpu_round", ROOT / "scripts" / "torch_gpu_round.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = sorted(p.name for p in tmp_path.iterdir())
    path = mod.ingest(str(tmp_path))
    assert Path(path).name == ledger.GPU_HISTORY_FILE == "GPU_PERF_history.jsonl"
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(before + [ledger.GPU_HISTORY_FILE])
    assert ledger.load_history(path) == ledger.build_gpu_history(str(tmp_path))
    # JAX's committed history is untouched and still reproduced byte for byte
    out = tmp_path / "PERF_history.jsonl"
    ledger.write_history(records, str(out))
    assert out.read_bytes() == (ROOT / ledger.HISTORY_FILE).read_bytes()


def test_the_committed_gpu_history_is_rebuilt_from_the_committed_reports(tmp_path):
    committed = ROOT / ledger.GPU_HISTORY_FILE
    assert ledger.discover_gpu_artifacts(str(ROOT)), "no GPU_* artifact is committed"
    out = tmp_path / ledger.GPU_HISTORY_FILE
    ledger.write_history(ledger.build_gpu_history(str(ROOT)), str(out))
    assert out.read_bytes() == committed.read_bytes()
    for rec in ledger.load_history(str(committed)):
        assert rec["source"].startswith("GPU_") and rec["platform"] == "gpu"
