"""The port's chaos drills (``mpcium_tpu_torch/faults/chaos.py``) on the
CPU (``device="cpu"``), as the JAX package's tier-1 drills run:

- drop-jitter at scale 0.15, partition, broker-failover, node-crash and
  kill-resume reach their expected outcomes through the real cluster
  stack (nodes, consumers, durable queues, registry liveness, the WAL)
  under an active fault plan, with the JAX tests' checks;
- the same (drill, seed) gives the same outcome and plan, and that plan
  is the JAX drill's byte for byte;
- the cheater's PRF-derived deviation (field, lane, byte, xor, and the
  party and check that must be blamed) equals the JAX drill's for
  several seeds, and the port's leg blames exactly that lane; the JAX
  leg's own blame vector and the whole cheater drill are slow-marked,
  as the JAX package's cheater drill is;
- ``DrillReport`` serializes with the JAX report's keys, and a drill
  asked for the GPU where there is none reports the error.
"""
from __future__ import annotations

import pytest
import torch

from mpcium_tpu.faults import chaos as jchaos

from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)
from torch_tcp import tcp_threads_down  # noqa: F401  (closes every client)

from mpcium_tpu_torch.faults import chaos as pchaos
from mpcium_tpu_torch.faults.chaos import run_drill
from mpcium_tpu_torch.faults.plan import named_plan

pytestmark = pytest.mark.chaos


def _assert_ok(report):
    assert report.ok, (
        f"drill {report.name!r} (seed {report.seed}) expected "
        f"{report.expected!r} got {report.outcome!r}: "
        f"error={report.error!r} notes={report.notes}"
    )


def test_drill_drop_jitter_fast():
    """keygen → 3 signatures → reshare → signature under 10% unicast
    loss + (scaled) jitter: the retry budgets absorb everything."""
    report = run_drill("drop-jitter", seed=3, scale=0.15, device="cpu")
    _assert_ok(report)
    assert report.plan["seed"] == 3 and report.plan["rules"]
    assert report.plan == jchaos.named_plan("drop-jitter", 3, scale=0.15).to_json()
    assert sum(a.get("delay", 0) for a in report.faults["counters"].values()) > 0


def test_drill_partition_loud_failure_then_recovery():
    """Over-threshold partition: signing fails LOUDLY (a bounded timeout
    ERROR event) and succeeds after the partition heals."""
    report = run_drill("partition", seed=5, device="cpu")
    _assert_ok(report)
    assert any("error" in n for n in report.notes)
    assert any(k.startswith("partition") for k in report.faults["counters"])


def test_drill_broker_failover():
    """Primary broker dies mid-run; clients walk to the hot standby."""
    report = run_drill("broker-failover", seed=13, device="cpu")
    _assert_ok(report)
    assert any("standby" in n for n in report.notes)


def test_drill_node_crash_recovers():
    """node2 SIGKILLs as it joins its first signing session: the tx
    fails loudly, survivors detect the death and sign with t+1, the
    restarted node rejoins, and the wallet reshares cleanly."""
    report = run_drill("node-crash", seed=11, device="cpu")
    _assert_ok(report)
    assert report.faults["counters"]["crash_node#0"]["crash"] == 1


def test_drill_kill_resume():
    """node2 SIGKILLs on its round-2 signing broadcast and is respawned
    over its on-disk state: the WAL session resumes mid-round and the
    SAME session completes with a bit-identical signature on all three
    nodes; the warm pass's stats ride the report."""
    report = run_drill("kill-resume", seed=7, device="cpu")
    _assert_ok(report)
    assert report.faults["counters"]["crash_node#0"]["crash"] == 1
    assert report.resume_latency_s > 0
    assert any("bit-identical" in n for n in report.notes)
    assert set(report.warm) == {"warmed", "hits", "budget_s"}
    assert report.warm["warmed"] >= 1
    assert report.to_json()["warm"] == report.warm


def test_drill_report_reproducible_from_seed():
    """Same (drill, seed) ⇒ same outcome and the identical serialized
    plan, which is the JAX drill's plan."""
    a = run_drill("drop-jitter", seed=21, scale=0.15, device="cpu")
    b = run_drill("drop-jitter", seed=21, scale=0.15, device="cpu")
    assert (a.outcome, a.ok, a.expected) == (b.outcome, b.ok, b.expected)
    assert a.plan == b.plan == jchaos.named_plan("drop-jitter", 21, scale=0.15).to_json()


def test_report_keys_catalog_and_a_missing_gpu_are_the_jax_contract():
    kw = dict(name="x", seed=1, expected="e", outcome="o", ok=True, duration_s=1.23456)
    assert list(pchaos.DrillReport(**kw).to_json()) == list(jchaos.DrillReport(**kw).to_json())
    assert pchaos.DrillReport(**kw).to_json() == jchaos.DrillReport(**kw).to_json()
    assert {n: e for n, (_f, e) in pchaos.DRILLS.items()} == \
        {n: e for n, (_f, e) in jchaos.DRILLS.items()}
    assert list(pchaos.DRILLS) == list(jchaos.DRILLS)
    assert pchaos.DEFAULT_SEED == jchaos.DEFAULT_SEED
    with pytest.raises(KeyError, match="unknown drill"):
        run_drill("no-such-drill", device="cpu")
    if not torch.cuda.is_available():
        report = run_drill("partition", seed=5)  # device=None: the GPU
        assert not report.ok and report.outcome == "error"
        assert "device='cpu'" in report.error


class _Stop(Exception):
    pass


def _jax_cheat_spec(seed: int, monkeypatch) -> tuple:
    """The JAX drill's own derivation: run its ``_drill_cheater`` up to
    the cluster it stands up next, and read its locals there."""
    def stop(*_a, **_k):
        raise _Stop

    monkeypatch.setattr(jchaos, "_mk_cluster", stop)
    with pytest.raises(_Stop) as info:
        jchaos._drill_cheater(seed, 1.0)
    tb = info.tb
    while tb.tb_frame.f_code.co_name != "_drill_cheater":
        tb = tb.tb_next
    loc = tb.tb_frame.f_locals
    return loc["spec"], loc["role"], loc["check"], loc["notes"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 7, 11, 13])
def test_cheater_deviation_spec_equals_the_jax_drills(seed, monkeypatch):
    spec, role, check, notes = _jax_cheat_spec(seed, monkeypatch)
    assert pchaos._cheat_spec(named_plan("cheater", seed)) == (spec, role, check)
    assert 0 <= spec["lane"] < pchaos.CHEAT_B
    assert notes[0].startswith(f"PRF-derived deviation: field={spec['field']} lane=")


def _port_blames(seed: int):
    from mpcium_tpu_torch.core import bignum as bn

    spec, role, check = pchaos._cheat_spec(named_plan("cheater", seed))
    a, g, w = pchaos._cheat_scalars(seed)
    leg = pchaos._synth_ot_leg(seed, "cpu")
    leg.set_tamper(spec)

    def limbs(vals):
        return torch.as_tensor(bn.batch_to_limbs(vals, bn.P256))

    leg.run_multi(limbs(a), (limbs(g), limbs(w)))
    return spec, role, check, leg.check_blame()


def test_cheater_leg_blames_exactly_the_cheating_lane():
    """On the CPU, the port's tampered leg blames the spec's party and
    check on the spec's lane and no one else — the blame vector the JAX
    drill requires (its ``caught`` and ``misblamed``)."""
    for seed in (7, 3):
        spec, role, check, blames = _port_blames(seed)
        want = [None] * pchaos.CHEAT_B
        want[spec["lane"]] = (role, check)
        assert blames == want, (seed, spec)


@pytest.mark.slow
def test_cheater_blame_vector_equals_the_jax_legs():
    """The JAX drill's leg (its ``_synth_ot_leg`` and scalars) under the
    same deviation gives the same blame vector (~40 s of JAX on the CPU)."""
    import jax.numpy as jnp

    from mpcium_tpu.core import bignum as jbn

    seed = 7
    spec, _role, _check, blames = _port_blames(seed)
    a, g, w = pchaos._cheat_scalars(seed)
    leg = jchaos._synth_ot_leg(seed)
    leg.set_tamper(spec)

    def limbs(vals):
        return jnp.asarray(jbn.batch_to_limbs(vals, jbn.P256))

    leg.run_multi(limbs(a), (limbs(g), limbs(w)))
    assert leg.check_blame() == blames


@pytest.mark.slow
def test_drill_cheater_caught_and_quarantined():
    """An active cheater corrupts one PRF-chosen OT-MtA wire field in
    one batch lane: the checks catch it and blame exactly the cheating
    party, the scheduler quarantines that session behind one retryable
    culprit-named ABORT event, the survivors re-pack onto pow-2
    sub-batches and complete — under live EdDSA traffic. Slow-marked
    like the JAX package's twin."""
    report = run_drill("cheater", seed=7, device="cpu")
    _assert_ok(report)
    assert set(report.culprit) == {"session", "lane", "party", "check", "field"}
    assert report.culprit["party"] in ("alice", "bob")
    s = report.survivors
    assert s["submitted"] == s["completed"] + s["quarantined"]
    assert s["pending"] == 0 and s["quarantined"] == 1
    assert all(isinstance(n, int) for n in s["chunks"])
    assert report.to_json()["culprit"] == report.culprit
    assert report.plan == jchaos.named_plan("cheater", 7).to_json()
    assert "OT leg device: cpu" in report.notes
