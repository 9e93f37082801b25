"""Declarative, seed-deterministic fault plans.

The port's copy of the JAX package's ``faults/plan.py``, pure stdlib and
equal to it draw for draw: the same ``(seed, rules)`` give the same PRF
draws, ``to_json`` and ``describe`` give the same bytes, and a plan JSON
written by either package loads in the other.

A plan is an ordered list of rules — ``drop(p=0.1, topic="sign:*")``,
``delay(ms=(50, 200))``, ``duplicate()``, ``reorder()``,
``crash_node("node2", at_round="r1")``, ``partition(["node1"], 5.0)``,
``tamper(p=1.0, topic="bsign:*", mode="flip")`` — each with match
predicates over topic / observing node / channel / direction.

Determinism contract: every probabilistic decision is a pure function
``PRF(seed, rule_id, message_key, occurrence)`` where ``message_key``
hashes (topic, payload) and ``occurrence`` counts how many times THIS
rule has judged THIS message key. Two consequences:

1. the same ``(seed, plan)`` over the same traffic yields the identical
   fault schedule regardless of thread interleaving — concurrent
   messages cannot steal each other's PRNG draws the way a shared
   ``random.Random`` stream would let them;
2. a retransmission of the same bytes (an acked-unicast retry) re-rolls
   with a bumped occurrence instead of being deterministically
   black-holed forever — loss is i.i.d. per delivery attempt, like a
   real lossy link.

Time-windowed rules (``partition``) and trigger rules (``crash_node``)
are deterministic by construction (wall-time window from
:meth:`FaultPlan.activate`; round-trigger from message content).

Plans serialize to/from JSON so a failed drill reproduces from its
report: ``FaultPlan.from_json(report["plan"])``.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def glob_match(pattern: str, value: str) -> bool:
    """Trailing-``*`` glob, the transport layer's own topic idiom
    (transport/loopback.py:topic_matches), extended with '*' matching
    everything."""
    if pattern == "*" or pattern == value:
        return True
    if pattern.endswith("*"):
        return value.startswith(pattern[:-1])
    return False


@dataclass(frozen=True)
class MsgEvent:
    """One message observed at a node's transport boundary."""

    direction: str  # "out" | "in"
    channel: str  # "pubsub" | "direct" | "queue"
    topic: str
    data: bytes
    node_id: str  # the node whose transport observed the message


@dataclass
class Rule:
    """One fault rule. ``kind`` ∈ {drop, delay, duplicate, reorder,
    crash_node, partition, tamper}; the constructor helpers below are
    the intended spelling."""

    kind: str
    p: float = 1.0
    topic: str = "*"
    node: str = "*"  # observing node (sender for "out", receiver for "in")
    channel: str = "*"  # pubsub | direct | queue | *
    direction: str = "out"  # out | in | *
    ms: Tuple[float, float] = (0.0, 0.0)  # delay bounds
    nodes: Tuple[str, ...] = ()  # partition: isolated nodes
    at_round: str = ""  # crash_node: fire when this round leaves the node
    start_s: float = 0.0  # partition: window start (from activate())
    duration_s: Optional[float] = None  # partition: None = until heal()
    mode: str = ""  # tamper: flip | truncate | replay ("" pre-tamper plans)
    rule_id: str = ""  # stable per-plan id (assigned by FaultPlan)

    def matches(self, ev: MsgEvent) -> bool:
        return (
            self.direction in ("*", ev.direction)
            and self.channel in ("*", ev.channel)
            and glob_match(self.topic, ev.topic)
            and glob_match(self.node, ev.node_id)
        )

    def to_json(self) -> dict:
        d = asdict(self)
        d["ms"] = list(self.ms)
        d["nodes"] = list(self.nodes)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Rule":
        d = dict(d)
        d["ms"] = tuple(d.get("ms", (0.0, 0.0)))
        d["nodes"] = tuple(d.get("nodes", ()))
        return cls(**d)


# -- rule constructors (the plan DSL) ---------------------------------------


def drop(p: float = 0.1, topic: str = "*", node: str = "*",
         channel: str = "*", direction: str = "out") -> Rule:
    """Lose matching messages with probability ``p`` per delivery
    attempt. On the acked-unicast channel a loss consumes one retry from
    the sender's budget (like a real lossy link under a retry protocol);
    on pub/sub and queue-enqueue it is a true loss."""
    return Rule(kind="drop", p=p, topic=topic, node=node, channel=channel,
                direction=direction)


def delay(ms: Tuple[float, float] = (50.0, 200.0), p: float = 1.0,
          topic: str = "*", node: str = "*", channel: str = "*",
          direction: str = "out") -> Rule:
    """Hold matching messages for a PRF-sampled jitter in ``ms`` before
    handing them on."""
    return Rule(kind="delay", p=p, ms=(float(ms[0]), float(ms[1])),
                topic=topic, node=node, channel=channel, direction=direction)


def duplicate(p: float = 1.0, topic: str = "*", node: str = "*",
              channel: str = "*", direction: str = "out") -> Rule:
    """Deliver matching messages twice (at-least-once semantics drill:
    queue consumers must be idempotent, dedup windows must hold)."""
    return Rule(kind="duplicate", p=p, topic=topic, node=node,
                channel=channel, direction=direction)


def reorder(p: float = 1.0, topic: str = "*", node: str = "*",
            channel: str = "*", direction: str = "out",
            window_ms: float = 100.0) -> Rule:
    """Hold a matching message back until the NEXT matching message has
    been sent (pairwise swap), flushing after ``window_ms`` if no
    successor shows up."""
    return Rule(kind="reorder", p=p, topic=topic, node=node, channel=channel,
                direction=direction, ms=(window_ms, window_ms))


def crash_node(node: str, at_round: str = "", topic: str = "*") -> Rule:
    """Kill ``node`` the moment it emits a message for ``at_round``
    (empty: its next outbound message). The transport flips its crash
    switch and fires the registered on-crash hook (chaos.py uses it to
    stop the registry heartbeat too — SIGKILL semantics)."""
    return Rule(kind="crash_node", node=node, at_round=at_round, topic=topic,
                direction="out")


TAMPER_MODES = ("flip", "truncate", "replay")


def tamper(p: float = 1.0, topic: str = "*", node: str = "*",
           channel: str = "*", direction: str = "out",
           mode: str = "flip") -> Rule:
    """Corrupt matching payloads in transit — the active-adversary
    drill (the protocol's KOS/Gilboa/consistency checks must catch,
    blame and survive this). Modes, all under the same
    PRF(seed, rule, msg, occurrence) contract:

    - ``flip``     XOR one PRF-chosen byte with a PRF-chosen nonzero
                   value (bit-level corruption a checksum-free wire
                   would pass through);
    - ``truncate`` cut the payload to a PRF-chosen strict prefix
                   (mid-message connection loss / short write);
    - ``replay``   substitute the rule's previously captured matching
                   payload (stale-message injection; the first match is
                   captured and passed through unmodified — under
                   concurrent senders "previous" follows arrival order,
                   so transcript-determinism drills run serial traffic).
    """
    if mode not in TAMPER_MODES:
        raise ValueError(f"tamper mode {mode!r}: expected one of "
                         f"{TAMPER_MODES}")
    return Rule(kind="tamper", p=p, topic=topic, node=node, channel=channel,
                direction=direction, mode=mode)


def partition(nodes: Sequence[str], duration_s: Optional[float] = None,
              start_s: float = 0.0) -> Rule:
    """Isolate ``nodes`` from everyone (drop all their traffic, both
    directions) during ``[start_s, start_s + duration_s)`` measured from
    :meth:`FaultPlan.activate`. ``duration_s=None`` holds until
    :meth:`FaultPlan.heal`."""
    return Rule(kind="partition", nodes=tuple(nodes), start_s=start_s,
                duration_s=duration_s, direction="*")


# -- the plan ----------------------------------------------------------------


def _msg_key(topic: str, data: bytes) -> bytes:
    return hashlib.sha256(topic.encode() + b"\x00" + data).digest()[:16]


class FaultPlan:
    """Seed + rules + the runtime occurrence state backing the PRF."""

    def __init__(self, seed: int, rules: Iterable[Rule] = ()):
        self.seed = int(seed)
        self.rules: List[Rule] = []
        for i, r in enumerate(rules):
            if not r.rule_id:
                r.rule_id = f"{r.kind}#{i}"
            self.rules.append(r)
        self._lock = threading.Lock()
        self._occ: Dict[Tuple[str, bytes], int] = {}
        self._epoch: Optional[float] = None
        self._healed = False
        self._fired: set = set()  # crash rules are one-shot events
        self._replay: Dict[str, bytes] = {}  # tamper(replay) capture cells

    # -- lifecycle ----------------------------------------------------------

    def activate(self, now: Optional[float] = None) -> "FaultPlan":
        """Anchor time-windowed rules (partition windows). Until this is
        called they are dormant — the drill runner arms them once the
        cluster is set up, so ``start_s`` is relative to the drill, not
        to transport construction. Probabilistic rules need no arming."""
        with self._lock:
            if self._epoch is None:
                self._epoch = time.monotonic() if now is None else now
        return self

    def heal(self) -> None:
        """End every partition immediately (drill 'partition heals')."""
        self._healed = True

    @property
    def empty(self) -> bool:
        return not self.rules

    # -- deterministic PRF --------------------------------------------------

    def _u(self, rule: Rule, key: bytes, occ: int, lane: str = "") -> float:
        h = hashlib.sha256(
            b"%d|%s|%d|%s|" % (self.seed, rule.rule_id.encode(), occ,
                               lane.encode()) + key
        ).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def roll(self, rule: Rule, ev: MsgEvent) -> Tuple[float, bytes, int]:
        """One judgement of ``ev`` by ``rule``: returns (uniform draw,
        message key, occurrence). Bumps the occurrence counter so a
        retransmission re-rolls independently."""
        key = _msg_key(ev.topic, ev.data)
        with self._lock:
            occ = self._occ.get((rule.rule_id, key), 0)
            self._occ[(rule.rule_id, key)] = occ + 1
        return self._u(rule, key, occ), key, occ

    def delay_ms(self, rule: Rule, key: bytes, occ: int) -> float:
        lo, hi = rule.ms
        return lo + self._u(rule, key, occ, lane="delay") * (hi - lo)

    def tamper_bytes(self, rule: Rule, key: bytes, occ: int, data: bytes,
                     triggered: bool = True) -> bytes:
        """The corrupted payload for one tamper judgement. Pure in
        (seed, rule, key, occ, data) for flip/truncate; replay reads and
        refreshes the rule's capture cell (every MATCH captures, so the
        substituted bytes are the previously observed matching payload).
        With ``triggered=False`` only the replay capture side effect
        runs and ``data`` passes through unchanged."""
        if rule.mode == "replay":
            with self._lock:
                prev = self._replay.get(rule.rule_id)
                self._replay[rule.rule_id] = data
            return prev if (triggered and prev is not None) else data
        if not triggered or not data:
            return data
        if rule.mode == "truncate":
            cut = int(self._u(rule, key, occ, lane="cut") * len(data))
            return data[:min(cut, len(data) - 1)]
        # flip (the default): one byte, nonzero mask — always corrupts
        idx = int(self._u(rule, key, occ, lane="idx") * len(data)) % len(data)
        mask = 1 + int(self._u(rule, key, occ, lane="val") * 255)
        return data[:idx] + bytes([data[idx] ^ mask]) + data[idx + 1:]

    # -- queries the transport asks ----------------------------------------

    def matching(self, ev: MsgEvent, kinds: Tuple[str, ...]) -> List[Rule]:
        return [r for r in self.rules
                if r.kind in kinds and r.matches(ev)]

    def isolated(self, node_id: str, now: Optional[float] = None) -> Optional[Rule]:
        """The partition rule currently isolating ``node_id``, if any."""
        if self._healed:
            return None
        with self._lock:
            epoch = self._epoch
        if epoch is None:
            return None  # windows dormant until activate()
        for r in self.rules:
            if r.kind != "partition" or node_id not in r.nodes:
                continue
            t = (time.monotonic() if now is None else now) - epoch
            if t < r.start_s:
                continue
            if r.duration_s is not None and t >= r.start_s + r.duration_s:
                continue
            return r
        return None

    def crash_rules(self, node_id: str) -> List[Rule]:
        """Unfired crash rules for ``node_id`` — each is a one-shot
        event (a restarted node must not deterministically re-die on its
        next message; mark_fired() retires the rule)."""
        with self._lock:
            return [r for r in self.rules
                    if r.kind == "crash_node"
                    and r.rule_id not in self._fired
                    and glob_match(r.node, node_id)]

    def mark_fired(self, rule: Rule) -> None:
        with self._lock:
            self._fired.add(rule.rule_id)

    # -- (de)serialization --------------------------------------------------

    def to_json(self) -> dict:
        return {"seed": self.seed, "rules": [r.to_json() for r in self.rules]}

    @classmethod
    def from_json(cls, d) -> "FaultPlan":
        if isinstance(d, (str, bytes)):
            d = json.loads(d)
        return cls(d["seed"], [Rule.from_json(r) for r in d.get("rules", [])])

    def describe(self) -> str:
        return "; ".join(
            f"{r.rule_id}(p={r.p},topic={r.topic},node={r.node})"
            for r in self.rules
        ) or "(empty)"


# -- named plans (the drill catalog's building blocks) -----------------------

# protocol traffic topic globs (wire.py topic composers)
PROTOCOL_TOPICS = ("keygen:*", "sign:*", "resharing:*")
# batched-session traffic (batch_scheduler.py session ids): batched signing,
# batched DKG, batched resharing — NOT covered by PROTOCOL_TOPICS, which
# predate the batch scheduler. The load-soak plan targets these.
BATCH_TOPICS = ("bsign:*", "bdkg:*", "brs:*")


def _protocol_rules(seed: int, p_drop: float, jitter: Tuple[float, float]):
    rules: List[Rule] = []
    for t in PROTOCOL_TOPICS:
        # losses hit the acked-unicast channel where a retry budget
        # exists; jitter hits every protocol message
        rules.append(drop(p=p_drop, topic=t, channel="direct"))
        rules.append(delay(ms=jitter, topic=t))
    return rules


def named_plan(name: str, seed: int,
               scale: float = 1.0) -> FaultPlan:
    """The drill catalog's plans. ``scale`` shrinks time constants for
    fast deterministic test-tier runs (delays and windows multiply by
    it); probabilities and structure never change with scale."""
    if name == "drop-jitter":
        return FaultPlan(seed, _protocol_rules(
            seed, p_drop=0.1, jitter=(50.0 * scale, 200.0 * scale)))
    if name == "node-crash":
        # node2 dies right after announcing itself in the first signing
        # round it participates in; the committee must finish without it
        return FaultPlan(seed, [crash_node("node2", topic="sign:*")])
    if name == "broker-failover":
        # no message-level rules: the fault is the primary broker dying
        # mid-run (the drill kills it); the plan records the intent
        return FaultPlan(seed, [])
    if name == "partition":
        # isolate two of three nodes — over threshold, no quorum can form
        return FaultPlan(seed, [partition(("node1", "node2"))])
    if name == "duplicate-reorder":
        rules: List[Rule] = []
        for t in PROTOCOL_TOPICS:
            rules.append(duplicate(p=0.2, topic=t, channel="queue"))
            rules.append(reorder(p=0.3, topic=t, channel="pubsub",
                                 window_ms=50.0 * scale))
        return FaultPlan(seed, rules)
    if name == "cheater":
        # one active deviation inside the OT-MtA rounds of a batched
        # signing cohort. The OT wire rounds never cross the
        # transport in the in-process engine, so the drill injects the
        # corruption protocol-level (mta_ot.OTMtALeg.set_tamper) with
        # lane/field/byte all PRF-derived from THIS plan's seed — the
        # rule records the intent and keys the derivation.
        return FaultPlan(seed, [tamper(p=1.0, topic="bsign:*", mode="flip")])
    if name == "batch-chaos":
        # the load-soak plan: jitter on every batched-session round plus
        # acked-unicast losses (the sender's retry budget absorbs them —
        # latency degrades, correctness must not), and jitter on the
        # manifest fan-out so window/fallback timing is exercised. Result
        # topics are left clean: the soak's accounting needs every
        # submitted request to produce SOME terminal event.
        rules = []
        for t in BATCH_TOPICS:
            rules.append(drop(p=0.05, topic=t, channel="direct"))
            rules.append(delay(ms=(5.0 * scale, 60.0 * scale), topic=t))
        rules.append(delay(ms=(5.0 * scale, 40.0 * scale),
                           topic="mpc:batch_manifest"))
        return FaultPlan(seed, rules)
    raise KeyError(f"unknown named plan {name!r}")
