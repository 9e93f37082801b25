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
