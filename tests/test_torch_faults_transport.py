"""The port's ``FaultyTransport`` (``mpcium_tpu_torch/faults/transport.py``)
against the JAX package's, each over its own package's loopback fabric:

- scripted traffic over pub/sub, acked unicast and the durable queue,
  outbound and inbound, under a plan of each fault kind (drop, delay,
  duplicate, reorder, tamper, partition, crash) gives the same
  ``canonical_schedule()``, the same counters and the same delivered
  bytes in both packages;
- with no plan the decorator passes every message through byte-identical
  and records nothing;
- a retried unicast re-rolls (the occurrence counter), ``FaultStats``
  merges and serializes as the JAX one does, and ``close()`` cancels
  every pending delayed delivery.
"""
from __future__ import annotations

import time

import pytest

from mpcium_tpu.faults import plan as jplan
from mpcium_tpu.faults import transport as jft
from mpcium_tpu.transport import api as japi
from mpcium_tpu.transport.loopback import LoopbackFabric as JFabric

from mpcium_tpu_torch.faults import plan as pplan
from mpcium_tpu_torch.faults import transport as pft
from mpcium_tpu_torch.transport import api as papi
from mpcium_tpu_torch.transport.loopback import LoopbackFabric as PFabric

PACKAGES = {"jax": (jplan, jft, japi, JFabric), "torch": (pplan, pft, papi, PFabric)}


def _env(round_: str, i: int) -> bytes:
    return b'{"round": "%s", "payload": {"i": %d}}' % (round_.encode(), i)


def _rules(m, kind: str):
    if kind == "drop":
        return [m.drop(p=0.4, topic="s:*"), m.drop(p=0.3, topic="in:*", direction="in")]
    if kind == "delay":
        return [m.delay(ms=(1.0, 6.0), topic="s:*"),
                m.delay(ms=(1.0, 3.0), p=0.5, topic="in:*", direction="in")]
    if kind == "duplicate":
        return [m.duplicate(p=0.5, topic="s:*")]
    if kind == "reorder":
        return [m.reorder(p=0.5, topic="s:ps:*", channel="pubsub", window_ms=10_000.0)]
    if kind == "tamper":
        return [m.tamper(p=0.7, topic="s:ps:*", channel="pubsub", mode="flip"),
                m.tamper(p=0.7, topic="s:q:*", channel="queue", mode="truncate"),
                m.tamper(p=1.0, topic="s:dm:*", channel="direct", mode="replay"),
                m.tamper(p=0.5, topic="in:*", direction="in", mode="flip")]
    if kind == "partition":
        return [m.partition(("nA",))]
    if kind == "crash":
        return [m.crash_node("nA", at_round="r2", topic="s:ps:*")]
    return []


def _script(pkg: str, kind: str, seed: int = 17):
    """Serial traffic from node nA's faulty transport to bare receivers,
    and from a bare sender to nA's faulty subscriptions → (canonical
    schedule, stats JSON, delivered bytes by channel, send errors)."""
    m, ftm, api, Fabric = PACKAGES[pkg]
    fabric = Fabric()
    try:
        plan = m.FaultPlan(seed, _rules(m, kind))
        ft = ftm.FaultyTransport(fabric.transport(), "nA", plan)
        bare = fabric.transport()
        got = {"pubsub": [], "direct": [], "queue": [], "in": []}
        bare.pubsub.subscribe("s:ps:*", lambda d: got["pubsub"].append(d))
        bare.direct.listen("s:dm:1", lambda d: got["direct"].append(d))
        bare.queues.dequeue("s:q:*", lambda d: got["queue"].append(d))
        ft.pubsub.subscribe("in:ps:*", lambda d: got["in"].append(d))
        ft.direct.listen("in:dm:1", lambda d: got["in"].append(d))
        if kind == "partition":
            plan.activate()
        errors = []
        for i in range(24):
            ft.pubsub.publish(f"s:ps:{i % 3}", _env(("r1", "r2")[i // 12], i))
            if i < 8:
                try:
                    ft.direct.send("s:dm:1", b"dm-%d" % (i % 5))
                except api.TransportError as e:
                    errors.append(("out", i, str(e)[:24]))
                try:
                    bare.direct.send("in:dm:1", b"in-dm-%d" % i, timeout_s=None)
                except api.TransportError as e:
                    errors.append(("in", i, str(e)[:24]))
            try:
                ft.queues.enqueue(f"s:q:{i % 2}", b"q-%d" % i, idempotency_key=f"k{i}")
                ft.queues.enqueue(f"s:q:{i % 2}", b"nokey-%d" % (i % 6))
            except api.TransportError as e:
                errors.append(("queue", i, str(e)[:24]))
            bare.pubsub.publish(f"in:ps:{i % 2}", b"in-%d" % (i % 9))
            fabric.drain(timeout_s=30)
        if kind == "partition":
            plan.heal()
            ft.pubsub.publish("s:ps:0", b"healed")
        time.sleep(0.1)  # delayed and held deliveries land
        fabric.drain(timeout_s=30)
        crashed = ft.crash_switch.crashed
        ft.close()
        return (ft.stats.canonical_schedule(), ft.stats.to_json(),
                {k: sorted(v) for k, v in got.items()}, errors, crashed)
    finally:
        fabric.close()


KINDS = ("drop", "delay", "duplicate", "reorder", "tamper", "partition", "crash")


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_counters_and_deliveries_equal_the_jax_transport(kind):
    port = _script("torch", kind)
    ref = _script("jax", kind)
    assert port[0] == ref[0]  # canonical schedule
    assert port[1] == ref[1]  # counters, retries, events
    assert port[2] == ref[2]  # delivered bytes, by channel
    assert port[3] == ref[3]  # send errors
    assert port[4] == ref[4]  # crash switch
    assert port[1]["events"] > 0, "the plan never fired"
    if kind == "crash":
        assert port[4] and port[1]["counters"]["crash_node#0"] == {"crash": 1}
        assert port[1]["counters"]["__crashed__"]["drop"] > 0


def test_no_plan_passes_through_byte_identical():
    """An empty plan is the bare transport: the same deliveries as a
    bare sender's (and as the JAX decorator's), and no record at all."""
    port = _script("torch", "none")
    assert port[0] == [] and port[3] == [] and not port[4]
    assert port[1] == {"counters": {}, "retries_observed": 0, "events": 0}
    assert port[2] == _script("jax", "none")[2]
    fabric = PFabric()
    try:
        got = {"bare": [], "wrapped": []}
        inner = fabric.transport()
        ft = pft.FaultyTransport(fabric.transport(), "nA", pplan.FaultPlan(7, []))
        for who, t in (("bare", inner), ("wrapped", ft)):
            fabric.transport().queues.dequeue(f"{who}:q", lambda d, w=who: got[w].append(d))
            for i in range(10):
                t.queues.enqueue(f"{who}:q", b"\x00\xff-%d" % i, idempotency_key=f"{who}{i}")
                t.queues.enqueue(f"{who}:q", b"\x00\xff-%d" % i, idempotency_key=f"{who}{i}")
        fabric.drain(timeout_s=30)
        assert sorted(got["wrapped"]) == sorted(got["bare"]) and len(got["bare"]) == 10
        assert ft.set_dead_letter_handler == inner.set_dead_letter_handler
    finally:
        fabric.close()


def test_retries_reroll_and_stats_merge_as_the_jax_stats():
    """A lost unicast consumes an attempt and re-rolls with the next
    occurrence; FaultStats merge/to_json/canonical_schedule match JAX's."""
    out = {}
    for pkg, (m, ftm, api, Fabric) in PACKAGES.items():
        fabric = Fabric()
        try:
            ft = ftm.FaultyTransport(fabric.transport(), "n",
                                     m.FaultPlan(5, [m.drop(p=0.5, topic="d:*",
                                                            channel="direct")]))
            fabric.transport().direct.listen("d:1", lambda d: None)
            for _ in range(6):
                try:
                    ft.direct.send("d:1", b"same-bytes")
                except api.TransportError:
                    pass
            merged = ftm.FaultStats().merge(ft.stats).merge(ft.stats)
            out[pkg] = (ft.stats.canonical_schedule(), ft.stats.to_json(),
                        merged.canonical_schedule(), merged.to_json())
        finally:
            fabric.close()
    assert out["torch"] == out["jax"]
    occs = [row[-1] for row in out["torch"][0]]
    assert occs == sorted(occs) and len(set(occs)) == len(occs) > 1


def test_close_cancels_every_pending_delivery():
    fabric = PFabric()
    try:
        ft = pft.FaultyTransport(fabric.transport(), "n",
                                 pplan.FaultPlan(1, [pplan.delay(ms=(400.0, 400.0))]))
        got = []
        fabric.transport().pubsub.subscribe("p:*", lambda d: got.append(d))
        fabric.transport().queues.dequeue("q:*", lambda d: got.append(d))
        for i in range(5):
            ft.pubsub.publish("p:1", b"late-%d" % i)
            ft.queues.enqueue("q:1", b"late-q-%d" % i)
        assert len(ft._timers._live) == 10
        ft.close()
        assert ft._timers._live == []
        ft.pubsub.publish("p:1", b"after-close")  # timers refuse new work
        time.sleep(0.6)
        fabric.drain(timeout_s=30)
        assert got == [] and ft._timers._live == []
        hooks = []
        ft.crash_switch.on_crash(lambda: hooks.append(1))
        ft.crash_switch.on_crash(lambda: 1 / 0)  # a failing hook must not cascade
        ft.crash_switch.crash()
        ft.crash_switch.crash()  # one flip, one run of the hooks
        assert hooks == [1] and ft.crash_switch.crash_count == 1
        ft.crash_switch.restore()
        assert not ft.crash_switch.crashed
    finally:
        fabric.close()
