"""The port's SLO load soak (``mpcium_tpu_torch/soak.py``) on the CPU:

- a soak of one burst under the batch-chaos plan on a port
  ``LocalCluster(device="cpu")`` closes its books —
  ``submitted == succeeded + shed + failed`` with ``pending == 0`` —
  with every lane empty, the trace spanning every layer and no thread
  left behind; the JAX package's smoke soak configuration (queue depth
  below the burst: backpressure sheds, retryable error events, client
  retries with fresh tx ids) with the JAX test's checks is slow-marked
  (see its docstring);
- without a cluster: the traffic schedule (``_mk_sign``: lane, wallet,
  deadline, tx bytes) equals the JAX soak's draw for draw for the same
  seed, ``SoakConfig``'s defaults and the latency summary are the JAX
  package's, and ``SoakRun``'s report over one ledger is the JAX soak's,
  key for key and number for number (its ``env`` reads torch).
"""
from __future__ import annotations

import json
import random
import threading

import pytest

from mpcium_tpu import soak as jsoak
from mpcium_tpu.faults import plan as jplan
from mpcium_tpu.utils.annotations import REGISTERED_THREAD_PREFIXES

from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)

from mpcium_tpu_torch import soak as psoak
from mpcium_tpu_torch.faults import plan as pplan
from mpcium_tpu_torch.trace import validate_chrome

pytestmark = pytest.mark.soak


def _foreign_threads():
    """Live non-daemon threads other than the main thread and the
    registered process-lifetime singletons (the JAX soak test's check),
    of which the port has one more: the cohort pipeline's ``pipe-host``
    worker, which ``pipe_host_down`` stops at module end."""
    return [
        t for t in threading.enumerate()
        if t is not threading.main_thread() and not t.daemon
        and not (t.name or "").startswith(REGISTERED_THREAD_PREFIXES + ("pipe-host",))
    ]


SMOKE = dict(
    n_nodes=3, threshold=1, n_wallets=3, n_sign=6, burst_size=6, burst_gap_s=0.1,
    seed=1234, interactive_fraction=0.5, interactive_deadline_ms=300_000,
    bulk_deadline_ms=600_000, max_retries=3, retry_backoff_s=0.4,
    chaos="batch-chaos", chaos_seed=7, chaos_scale=0.25, batch_window_s=0.25,
    batch_max_batch=1024, batch_max_queue_depth=3, manifest_timeout_s=120.0,
    wait_timeout_s=420.0,
)


@pytest.mark.slow
def test_smoke_soak_sheds_retries_and_closes_the_books(tmp_path):
    """The JAX smoke soak's configuration and checks. Slow-marked: under
    a loaded host (the suite on six workers) the three nodes' bounded
    queues can shed different requests of one burst, and a follower then
    holds a request the leader shed (and the client retried under a
    fresh id) until its manifest fallback, so the end-of-run lane depth
    reads 1 there; the JAX twin fails the same way (ROADMAP Queue 3)."""
    report = psoak.run_soak(psoak.SoakConfig(root_dir=str(tmp_path), **SMOKE), device="cpu")

    out = report["outcomes"]
    assert report["accounting_ok"], report
    assert out["pending"] == 0 and out["submitted"] == 6
    assert out["submitted"] == out["succeeded"] + out["shed"] + out["failed"]
    # shed is retryable, not fatal: every request ultimately signs
    assert out["succeeded"] == 6 and out["failed"] == 0
    assert report["by_kind"]["sign"]["succeeded"] == 6
    # the burst overflowed the bounded queue, loudly, and the client's
    # retry (fresh tx id) recovered each shed request
    sched = report["scheduler"]
    assert sched["shed_backpressure"] >= 1 and out["retries"] >= 1
    assert sched["batches_fired"] >= 2 and sched["fallbacks"] == 0
    for node, snap in sched["per_node"].items():
        c, g = snap["counters"], snap["gauges"]
        assert c["scheduler.shed_total"] == (
            c["scheduler.shed_backpressure_total"] + c["scheduler.shed_deadline_total"]), (node, c)
        assert g["scheduler.queue_depth.interactive"] == 0, (node, g)
        assert g["scheduler.queue_depth.bulk"] == 0, (node, g)
        assert c["scheduler.submitted_total"] >= 6, (node, c)
        assert c.get("scheduler.declined_total", 0.0) == 0, (node, c)
    assert report["latency_ms"]["overall"]["count"] == 6
    # the merged cross-node trace spans every instrumented layer
    trace = report["trace"]
    assert validate_chrome(trace) > 0
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") != "M"}
    assert {"intake", "queue", "dispatch", "session"} <= names, sorted(names)
    assert any(n.startswith("round:") for n in names), sorted(names)
    assert any(n.startswith("phase:") for n in names), sorted(names)
    assert len({e["pid"] for e in trace["traceEvents"]}) >= 3
    assert "scheduler_batches_fired_total" in report["prometheus"]
    assert 'node="node0"' in report["prometheus"]
    assert report["env"]["platform"] == "cpu" and report["env"]["torch"]
    assert report["chaos"]["rules"] == jplan.named_plan("batch-chaos", 7, 0.25).describe()
    # and the report has the JAX report's keys, section by section
    want = _stub_report(jsoak)
    assert list(report) == list(want)
    for k in ("config", "chaos", "outcomes", "by_kind", "latency_ms", "throughput",
              "scheduler"):
        assert list(report[k]) == list(want[k]), k
    leaked = _foreign_threads()
    assert not leaked, [t.name for t in leaked]


def test_soak_under_chaos_without_backpressure_closes_the_books(tmp_path):
    """A soak the nodes cannot diverge on: one burst of three signs under
    the batch-chaos plan with room in every queue — one batch, every
    request signed, the books closed, every lane empty at the end, the
    trace spanning every layer, and no thread left behind."""
    cfg = dict(SMOKE, n_sign=3, burst_size=3, batch_max_queue_depth=100)
    report = psoak.run_soak(psoak.SoakConfig(root_dir=str(tmp_path), **cfg), device="cpu")
    out = report["outcomes"]
    assert report["accounting_ok"] and out["pending"] == 0, report
    assert out["succeeded"] == out["submitted"] == 3 and out["failed"] == 0
    assert report["scheduler"]["shed_total"] == 0 and report["scheduler"]["fallbacks"] == 0
    assert report["scheduler"]["batches_fired"] >= 1
    for node, snap in report["scheduler"]["per_node"].items():
        assert snap["gauges"]["scheduler.queue_depth.interactive"] == 0, node
        assert snap["gauges"]["scheduler.queue_depth.bulk"] == 0, node
        assert snap["counters"].get("scheduler.declined_total", 0.0) == 0, node
    assert report["latency_ms"]["overall"]["count"] == 3
    names = {e["name"] for e in report["trace"]["traceEvents"] if e.get("ph") != "M"}
    assert {"intake", "queue", "dispatch", "session"} <= names, sorted(names)
    assert report["env"]["platform"] == "cpu"
    leaked = _foreign_threads()
    assert not leaked, [t.name for t in leaked]


class _StubCluster:
    """The three cluster reads of a soak report."""

    def metrics_snapshot(self):
        return {f"node{i}": {"counters": {"scheduler.batches_fired_total": 2.0 + i,
                                          "scheduler.shed_total": 1.0,
                                          "scheduler.shed_backpressure_total": 1.0},
                             "gauges": {}} for i in range(3)}

    def prometheus_text(self):
        return "scheduler_batches_fired_total 2.0\n"

    def trace_snapshot(self, clear=False, meta=None):
        return {"traceEvents": [], "otherData": dict(meta or {})}


def _stub_report(mod) -> dict:
    """``SoakRun._report`` of package ``mod`` over one fixed ledger (every
    outcome, both lanes, a warmup request, retries, a late event)."""
    cfg = mod.SoakConfig(seed=5, n_wallets=4, chaos="batch-chaos")
    run = mod.SoakRun.__new__(mod.SoakRun)
    run.cfg, run.cluster = cfg, _StubCluster()
    run._plan = (jplan if mod is jsoak else pplan).named_plan("batch-chaos", 7)
    run._lock = threading.Lock()
    run._retries, run._late_events = 4, 2
    run._reqs = {}
    for i, (status, lane, dt) in enumerate([
            ("succeeded", "interactive", 1.5), ("succeeded", "bulk", 700.0),
            ("shed", "bulk", 2.0), ("failed", "interactive", 3.0),
            ("succeeded", "bulk", 0.25), ("pending", "bulk", 0.0)]):
        r = mod._Req(kind="sign" if i != 4 else "reshare", base_id=f"b{i}", wallet_id="w",
                     lane=lane, deadline_ms=120_000 if lane == "interactive" else 600_000,
                     submitted_at=10.0, status=status, done_at=10.0 + dt, warmup=i == 5)
        run._reqs[r.base_id] = r
    return run._report(list(run._reqs.values()), 10.0, 30.0)


def test_report_over_one_ledger_equals_the_jax_soaks():
    """The same ledger gives the same report (every key and number) in
    both packages, but for ``env``: torch's fingerprint, not jax's."""
    port, ref = _stub_report(psoak), _stub_report(jsoak)
    penv, jenv = port.pop("env"), ref.pop("env")
    assert port == ref and json.dumps(port) == json.dumps(ref)
    assert port["accounting_ok"] is True and port["outcomes"]["failed"] == 1
    assert set(penv) == set(jenv) - {"jax"} | {"torch", "cuda"}
    assert penv["git_sha"] == jenv["git_sha"] and penv["host"] == jenv["host"]


def _schedule(mod, cfg, n: int):
    run = mod.SoakRun.__new__(mod.SoakRun)  # the schedule needs no cluster
    run.cfg = cfg
    run._rng = random.Random(cfg.seed)
    run.wallets = [f"soakw{w}" for w in range(cfg.n_wallets)]
    return [(r.base_id, r.wallet_id, r.lane, r.deadline_ms, r.tx, r.warmup)
            for r in [run._mk_sign(i, warmup=i % 5 == 0) for i in range(n)]]


@pytest.mark.parametrize("seed,wallets,frac", [(1337, 12, 0.25), (1234, 3, 0.5), (7, 8, 0.9)])
def test_traffic_schedule_equals_the_jax_soaks(seed, wallets, frac):
    kw = dict(seed=seed, n_wallets=wallets, interactive_fraction=frac)
    port = _schedule(psoak, psoak.SoakConfig(**kw), 200)
    assert port == _schedule(jsoak, jsoak.SoakConfig(**kw), 200)
    assert {lane for _b, _w, lane, *_ in port} == {"interactive", "bulk"}


def test_config_defaults_and_latency_summary_are_the_jax_packages(tmp_path):
    from dataclasses import asdict

    assert asdict(psoak.SoakConfig()) == asdict(jsoak.SoakConfig())
    rng = random.Random(3)
    for n in (0, 1, 2, 7, 100):
        vals = [rng.uniform(0, 5000) for _ in range(n)]
        assert psoak._latency_summary(vals) == jsoak._latency_summary(vals)
    rep = {"a": 1, "b": [1.5, "x"]}
    psoak.write_report(rep, str(tmp_path / "p.json"))
    jsoak.write_report(rep, str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
