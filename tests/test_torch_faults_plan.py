"""The port's fault plans (``mpcium_tpu_torch/faults/plan.py``) against the
JAX package's, on the same seeds and rules:

- every PRF draw — ``_u`` on each lane, ``roll`` (uniform, message key,
  occurrence), ``delay_ms``, ``tamper_bytes`` in each mode, the
  ``isolated`` window and the one-shot crash triggers — equals the JAX
  plan's, for a plan of every rule kind and for every ``named_plan`` of
  the catalog at scales 1.0, 0.25 and 0.15;
- ``to_json`` and ``describe`` give the same bytes, and a plan JSON
  written by either package loads in the other with the same draws;
- the rule makers, ``glob_match`` and the errors (an unknown plan name,
  an unknown tamper mode) are the JAX package's.
"""
from __future__ import annotations

import json

import pytest

from mpcium_tpu.faults import plan as jp

from mpcium_tpu_torch.faults import plan as pp

CATALOG = ("drop-jitter", "node-crash", "broker-failover", "partition",
           "duplicate-reorder", "cheater", "batch-chaos")
SCALES = (1.0, 0.25, 0.15)


def _every_kind(m, seed: int):
    """One rule of every kind, with non-default predicates, in package
    ``m``."""
    return m.FaultPlan(seed, [
        m.drop(p=0.5, topic="t:*", channel="direct"),
        m.delay(ms=(10.0, 20.0), p=0.7, topic="t:*", direction="*"),
        m.duplicate(p=0.3, topic="t:1", channel="queue"),
        m.reorder(p=0.4, topic="t:*", channel="pubsub", window_ms=25.0),
        m.crash_node("nodeX", at_round="r1", topic="t:*"),
        m.tamper(p=0.6, topic="t:*", mode="flip"),
        m.tamper(p=0.6, topic="t:2", mode="truncate", direction="in"),
        m.tamper(p=1.0, topic="t:3", mode="replay"),
        m.partition(("nodeX", "nodeY"), duration_s=2.0, start_s=1.0),
    ])


def _traffic(m):
    return [
        m.MsgEvent(("out", "in")[i % 2], ("direct", "pubsub", "queue")[i % 3],
                   f"t:{i % 5}", b"payload-%d" % (i % 7), ("nodeX", "nodeZ")[i % 2])
        for i in range(90)
    ]


def _draws(m, plan) -> list:
    """Every draw a transport would ask ``plan`` for over the traffic,
    and the window and trigger answers, in one list."""
    out = []
    for ev in _traffic(m):
        for r in plan.matching(ev, ("drop", "delay", "duplicate", "reorder", "tamper")):
            u, key, occ = plan.roll(r, ev)
            row = [r.rule_id, u, key.hex(), occ]
            for lane in ("", "delay", "cut", "idx", "val", "lane", "field", "byte", "xor"):
                row.append(plan._u(r, key, occ, lane=lane))
            if r.kind == "delay":
                row.append(plan.delay_ms(r, key, occ))
            if r.kind == "tamper":
                row.append(plan.tamper_bytes(r, key, occ, ev.data, triggered=u < r.p).hex())
            out.append(row)
    for rule in plan.rules:
        out.append([rule.rule_id] + [plan._u(rule, b"cheat", 0, lane=ln)
                                     for ln in ("lane", "field", "byte", "xor")])
    out.append([plan.isolated(n, now=t) is not None
                for n in ("nodeX", "nodeY", "node1", "node2") for t in (0.5, 1.5, 3.5)])
    plan.activate(now=0.0)
    out.append([getattr(plan.isolated(n, now=t), "rule_id", None)
                for n in ("nodeX", "nodeY", "node1", "node2") for t in (0.5, 1.5, 3.5, 1e6)])
    for node in ("nodeX", "node2", "nodeZ"):
        fired = [r.rule_id for r in plan.crash_rules(node)]
        for r in plan.crash_rules(node):
            plan.mark_fired(r)
        out.append([node, fired, [r.rule_id for r in plan.crash_rules(node)]])
    plan.heal()
    out.append([plan.isolated(n, now=1.5) for n in ("nodeX", "node1")])
    return out


def _pair(name: str, seed: int, scale: float):
    if name == "every-kind":
        return _every_kind(jp, seed), _every_kind(pp, seed)
    return jp.named_plan(name, seed, scale=scale), pp.named_plan(name, seed, scale=scale)


PLANS = [("every-kind", 1.0)] + [(n, s) for n in CATALOG for s in SCALES]


@pytest.mark.parametrize("name,scale", PLANS)
def test_every_draw_json_and_describe_equal_the_jax_plan(name, scale):
    for seed in (0, 7, 1234):
        jplan, pplan = _pair(name, seed, scale)
        assert json.dumps(pplan.to_json()) == json.dumps(jplan.to_json())
        assert pplan.describe() == jplan.describe()
        assert pplan.empty == jplan.empty
        assert _draws(pp, pplan) == _draws(jp, jplan)


@pytest.mark.parametrize("name,scale", PLANS)
def test_plan_json_loads_in_the_other_package(name, scale):
    jplan, pplan = _pair(name, 11, scale)
    for src, dst in ((jplan, pp), (pplan, jp)):
        text = json.dumps(src.to_json())
        loaded = dst.FaultPlan.from_json(text)
        assert loaded.to_json() == src.to_json()
        assert dst.FaultPlan.from_json(text.encode()).to_json() == src.to_json()
        assert loaded.describe() == src.describe()
        fresh = dst.FaultPlan.from_json(src.to_json())
        ref = (jp if dst is pp else pp).FaultPlan.from_json(text)
        assert _draws(dst, fresh) == _draws(jp if dst is pp else pp, ref)


def test_rule_makers_globs_and_errors_are_the_jax_packages():
    assert pp.TAMPER_MODES == jp.TAMPER_MODES
    assert (pp.PROTOCOL_TOPICS, pp.BATCH_TOPICS) == (jp.PROTOCOL_TOPICS, jp.BATCH_TOPICS)
    makers = [("drop", {}), ("delay", {"ms": (1, 2)}), ("duplicate", {}),
              ("reorder", {"window_ms": 5.0}), ("crash_node", {"node": "n1"}),
              ("tamper", {"mode": "replay"}), ("partition", {"nodes": ["n1"]})]
    for fn, kw in makers:
        assert getattr(pp, fn)(**kw).to_json() == getattr(jp, fn)(**kw).to_json()
        assert pp.Rule.from_json(getattr(jp, fn)(**kw).to_json()) == \
            pp.Rule.from_json(getattr(pp, fn)(**kw).to_json())
    for pat, val in [("*", "x"), ("a:*", "a:b"), ("a:*", "b:a"), ("a", "a"), ("a", "ab"),
                     ("sign:*", "sign:"), ("", "")]:
        assert pp.glob_match(pat, val) == jp.glob_match(pat, val)
    with pytest.raises(ValueError, match="tamper mode"):
        pp.tamper(mode="scramble")
    with pytest.raises(KeyError, match="unknown named plan"):
        pp.named_plan("no-such-plan", 1)
    assert pp.FaultPlan(1).describe() == jp.FaultPlan(1).describe() == "(empty)"
