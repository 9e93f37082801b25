"""FaultyTransport: a fault-injecting decorator over any Transport.

The port's copy of the JAX package's ``faults/transport.py``, over the
port's ``transport/api.py``: with no plan it passes every message through
byte-identical, and with a plan the same scripted traffic gives the same
``canonical_schedule()`` and counters as the JAX decorator.

Wraps the four delivery semantics of :class:`~..transport.api.Transport`
(loopback or TCP) and applies the active :class:`~.plan.FaultPlan` on
every publish/send/enqueue (outbound) and every handler delivery
(inbound). Construction is the only seam — a node built without a plan
never touches this module and runs byte-identically (the zero-overhead
contract tested by tests/test_torch_faults_transport.py).

Semantics per channel:

- **pub/sub** — drop is a true loss (fire-and-forget fan-out), delay
  re-publishes after the jitter on a timer thread, reorder swaps a
  message with its successor;
- **acked unicast** — a drop consumes one of the sender's retry
  attempts then re-rolls (a lossy link under a retry protocol, not a
  forged ack: the caller either gets a real ack or a TransportError);
- **durable queue** — drop loses the enqueue, duplicate re-enqueues
  (drilling Nats-Msg-Id idempotency), delay defers it.

Tamper rules (active adversary) corrupt the payload on any
channel — outbound before delivery, inbound before the handler — via
:meth:`~.plan.FaultPlan.tamper_bytes` (PRF-chosen byte flip, truncate,
or replay substitution); the delivered bytes differ, the schedule log
records the judgement.

The :class:`CrashSwitch` gives SIGKILL semantics: once flipped, the node
emits nothing and hears nothing (its subscriptions stay registered, like
a dead process's socket buffers) until :meth:`CrashSwitch.restore`.
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from ..transport.api import (
    DirectMessaging,
    Handler,
    MessageQueue,
    PubSub,
    QueueHandler,
    Subscription,
    Transport,
    TransportError,
)
from ..utils import log
from .plan import FaultPlan, MsgEvent, Rule

# pseudo-rule ids for non-probabilistic suppression, so reports show them
CRASH_RULE = "__crashed__"


class CrashSwitch:
    """Process-death toggle shared by a node's transport and the drill
    runner. ``on_crash`` hooks run once per flip (chaos.py registers the
    registry-heartbeat stopper there)."""

    def __init__(self, node_id: str = ""):
        self.node_id = node_id
        self._crashed = threading.Event()
        self._hooks: List[Callable[[], None]] = []
        self.crash_count = 0

    @property
    def crashed(self) -> bool:
        return self._crashed.is_set()

    def on_crash(self, hook: Callable[[], None]) -> None:
        self._hooks.append(hook)

    def crash(self) -> None:
        if self._crashed.is_set():
            return
        self._crashed.set()
        self.crash_count += 1
        log.warn("FAULT: node crashed", node=self.node_id)
        for h in list(self._hooks):
            try:
                h()
            except Exception as e:  # noqa: BLE001 — hooks must not cascade
                log.warn("crash hook failed", error=repr(e))

    def restore(self) -> None:
        log.info("FAULT: node restored", node=self.node_id)
        self._crashed.clear()


class FaultStats:
    """Counters + the deterministic schedule log, per transport; merged
    across a cluster into the drill report."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int)
        )
        self.schedule: List[dict] = []
        self.retries_observed = 0

    def record(self, rule_id: str, action: str, ev: MsgEvent,
               key: bytes = b"", occ: int = 0, **extra) -> None:
        entry = {
            "rule": rule_id, "action": action, "channel": ev.channel,
            "direction": ev.direction, "topic": ev.topic,
            "node": ev.node_id, "key": key.hex(), "occ": occ,
        }
        entry.update(extra)
        with self._lock:
            self.counters[rule_id][action] += 1
            self.schedule.append(entry)

    def retry(self) -> None:
        with self._lock:
            self.retries_observed += 1

    def merge(self, other: "FaultStats") -> "FaultStats":
        with other._lock:
            sched, counters = list(other.schedule), dict(other.counters)
            retries = other.retries_observed
        with self._lock:
            self.schedule.extend(sched)
            for rid, acts in counters.items():
                for a, n in acts.items():
                    self.counters[rid][a] += n
            self.retries_observed += retries
        return self

    def canonical_schedule(self) -> List[tuple]:
        """Order-independent view for determinism assertions: the
        schedule as a sorted multiset (thread interleaving may permute
        append order between runs; the *set of judgements* may not
        differ)."""
        with self._lock:
            return sorted(
                (e["rule"], e["action"], e["channel"], e["direction"],
                 e["topic"], e["node"], e["key"], e["occ"])
                for e in self.schedule
            )

    def to_json(self) -> dict:
        with self._lock:
            return {
                "counters": {r: dict(a) for r, a in self.counters.items()},
                "retries_observed": self.retries_observed,
                "events": len(self.schedule),
            }


class _Timers:
    """Tracked daemon timers for delayed/reordered deliveries."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: List[threading.Timer] = []
        self._closed = False

    def after(self, delay_s: float, fn: Callable[[], None]) -> threading.Timer:
        def run():
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — late delivery races close
                log.warn("delayed fault delivery failed", error=repr(e))
            with self._lock:
                if t in self._live:
                    self._live.remove(t)

        t = threading.Timer(delay_s, run)
        t.daemon = True
        with self._lock:
            if self._closed:
                return t
            self._live.append(t)
        t.start()
        return t

    def close(self) -> None:
        with self._lock:
            self._closed = True
            live, self._live = self._live, []
        for t in live:
            t.cancel()


class _FaultSub(Subscription):
    def __init__(self, inner: Subscription):
        self._inner = inner

    def unsubscribe(self) -> None:
        self._inner.unsubscribe()


class FaultyTransport:
    """Transport decorator. Satisfies the :class:`Transport` bundle
    contract (``pubsub`` / ``direct`` / ``queues`` /
    ``set_dead_letter_handler``) and forwards any extra attributes of
    the wrapped bundle (e.g. the TCP bundle's ``client``)."""

    def __init__(self, inner: Transport, node_id: str, plan: FaultPlan,
                 stats: Optional[FaultStats] = None,
                 crash_switch: Optional[CrashSwitch] = None):
        self.inner = inner
        self.node_id = node_id
        self.plan = plan
        self.stats = stats or FaultStats()
        self.crash_switch = crash_switch or CrashSwitch(node_id)
        self._timers = _Timers()
        # reorder holding cells: rule_id -> (emit_fn, timer, ev)
        self._held: Dict[str, Tuple[Callable[[], None], threading.Timer, MsgEvent]] = {}
        self._held_lock = threading.Lock()
        self.pubsub = _FaultyPubSub(self)
        self.direct = _FaultyDirect(self)
        self.queues = _FaultyQueue(self)
        self.set_dead_letter_handler = inner.set_dead_letter_handler

    def __getattr__(self, name):
        # forward e.g. `.client` (TCP bundle) — only called for misses
        if name == "inner":  # guard: never recurse during construction
            raise AttributeError(name)
        return getattr(self.inner, name)

    def close(self) -> None:
        self._timers.close()

    # -- shared machinery ----------------------------------------------------

    def _suppressed(self, ev: MsgEvent) -> bool:
        """Crash/partition: the message never crosses this boundary."""
        if self.crash_switch.crashed:
            self.stats.record(CRASH_RULE, "drop", ev)
            return True
        iso = self.plan.isolated(self.node_id)
        if iso is not None:
            self.stats.record(iso.rule_id, "drop", ev)
            return True
        return False

    def _roll_drop(self, ev: MsgEvent) -> Optional[Rule]:
        for r in self.plan.matching(ev, ("drop",)):
            u, key, occ = self.plan.roll(r, ev)
            if u < r.p:
                self.stats.record(r.rule_id, "drop", ev, key, occ)
                return r
        return None

    def _sample_delay_s(self, ev: MsgEvent) -> float:
        total = 0.0
        for r in self.plan.matching(ev, ("delay",)):
            u, key, occ = self.plan.roll(r, ev)
            if u < r.p:
                d_ms = self.plan.delay_ms(r, key, occ)
                self.stats.record(r.rule_id, "delay", ev, key, occ,
                                  ms=round(d_ms, 3))
                total += d_ms / 1000.0
        return total

    def _roll_tamper(self, ev: MsgEvent) -> Optional[bytes]:
        """The corrupted payload when a tamper rule fires, else None.
        Rolled on the ORIGINAL bytes (the message key and occurrence
        stream never depend on what an earlier tamper rule did), applied
        cumulatively when several rules fire."""
        data = ev.data
        hit = False
        for r in self.plan.matching(ev, ("tamper",)):
            u, key, occ = self.plan.roll(r, ev)
            out = self.plan.tamper_bytes(r, key, occ, data,
                                         triggered=u < r.p)
            if out != data:
                self.stats.record(r.rule_id, "tamper", ev, key, occ,
                                  mode=r.mode, nbytes=len(out))
                data = out
                hit = True
        return data if hit else None

    def _roll_duplicate(self, ev: MsgEvent) -> bool:
        dup = False
        for r in self.plan.matching(ev, ("duplicate",)):
            u, key, occ = self.plan.roll(r, ev)
            if u < r.p:
                self.stats.record(r.rule_id, "duplicate", ev, key, occ)
                dup = True
        return dup

    def _maybe_crash_after(self, ev: MsgEvent) -> None:
        """crash_node trigger: the node just emitted ``ev``; if a crash
        rule matches (topic + round predicate), flip the switch — the
        message it rode out on was its last."""
        for r in self.plan.crash_rules(self.node_id):
            if not (r.topic in ("*",) or _topic_match(r.topic, ev.topic)):
                continue
            if r.at_round:
                if _envelope_round(ev.data) != r.at_round:
                    continue
            self.plan.mark_fired(r)
            self.stats.record(r.rule_id, "crash", ev)
            self.crash_switch.crash()
            return

    def _reorder(self, ev: MsgEvent, emit: Callable[[], None]) -> bool:
        """Returns True when the message was consumed by a reorder hold
        (it will be emitted later); False to emit normally."""
        for r in self.plan.matching(ev, ("reorder",)):
            rid = r.rule_id
            with self._held_lock:
                held = self._held.pop(rid, None)
            if held is not None:
                # successor arrived: emit it first, then the held one
                held_emit, timer, _held_ev = held
                timer.cancel()
                emit()
                held_emit()
                return True
            u, key, occ = self.plan.roll(r, ev)
            if u < r.p:
                self.stats.record(rid, "reorder", ev, key, occ)

                def flush(rid=rid):
                    with self._held_lock:
                        held2 = self._held.pop(rid, None)
                    if held2 is not None:
                        held2[0]()

                timer = self._timers.after(r.ms[0] / 1000.0, flush)
                with self._held_lock:
                    self._held[rid] = (emit, timer, ev)
                return True
        return False

    # -- inbound wrap --------------------------------------------------------

    def _wrap_handler(self, channel: str, topic: str, handler):
        def wrapped(data: bytes):
            ev = MsgEvent("in", channel, topic, data, self.node_id)
            if self._suppressed(ev):
                # a crashed/isolated node hears nothing; for the acked
                # channels the missing ack is exactly what a dead
                # process produces — the sender's retry budget decides
                if channel in ("direct", "queue"):
                    raise TransportError(
                        f"fault: {self.node_id} unreachable"
                    )
                return None
            if self._roll_drop(ev) is not None:
                if channel in ("direct", "queue"):
                    raise TransportError("fault: inbound delivery dropped")
                return None
            d = self._sample_delay_s(ev)
            if d > 0:
                time.sleep(d)
            t = self._roll_tamper(ev)
            return handler(data if t is None else t)

        return wrapped


def _topic_match(pattern: str, topic: str) -> bool:
    from .plan import glob_match

    return glob_match(pattern, topic)


def _envelope_round(data: bytes) -> str:
    """Best-effort round extraction from a wire Envelope (JSON)."""
    try:
        return str(json.loads(data).get("round", ""))
    except Exception:  # noqa: BLE001 — non-envelope payloads have no round
        return ""


class _FaultyPubSub(PubSub):
    def __init__(self, ft: FaultyTransport):
        self._ft = ft

    def publish(self, topic: str, data: bytes) -> None:
        ft = self._ft
        ev = MsgEvent("out", "pubsub", topic, data, ft.node_id)
        if ft.plan.empty and not ft.crash_switch.crashed:
            ft.inner.pubsub.publish(topic, data)
            return
        if ft._suppressed(ev):
            return
        if ft._roll_drop(ev) is not None:
            ft._maybe_crash_after(ev)
            return
        t = ft._roll_tamper(ev)
        payload = data if t is None else t

        def emit():
            ft.inner.pubsub.publish(topic, payload)
            if ft._roll_duplicate(ev):
                ft.inner.pubsub.publish(topic, payload)

        if ft._reorder(ev, emit):
            ft._maybe_crash_after(ev)
            return
        d = ft._sample_delay_s(ev)
        if d > 0:
            ft._timers.after(d, emit)
        else:
            emit()
        ft._maybe_crash_after(ev)

    def publish_with_reply(self, topic: str, reply_topic: str, data: bytes) -> None:
        # the wrapped fabric's reply envelope rides publish() semantics;
        # fault rules match on the OUTER topic
        ft = self._ft
        ev = MsgEvent("out", "pubsub", topic, data, ft.node_id)
        if not ft.plan.empty or ft.crash_switch.crashed:
            if ft._suppressed(ev) or ft._roll_drop(ev) is not None:
                return
            d = ft._sample_delay_s(ev)
            if d > 0:
                ft._timers.after(
                    d, lambda: ft.inner.pubsub.publish_with_reply(
                        topic, reply_topic, data)
                )
                return
        ft.inner.pubsub.publish_with_reply(topic, reply_topic, data)

    def subscribe(self, topic: str, handler: Handler) -> Subscription:
        ft = self._ft
        return _FaultSub(ft.inner.pubsub.subscribe(
            topic, ft._wrap_handler("pubsub", topic, handler)))


class _FaultyDirect(DirectMessaging):
    # a lossy link under the acked-retry protocol: each PRF'd loss
    # consumes one attempt and re-rolls with a bumped occurrence
    DROP_ATTEMPTS = 3
    RETRY_DELAY_S = 0.05

    def __init__(self, ft: FaultyTransport):
        self._ft = ft

    def send(self, topic: str, data: bytes,
             timeout_s: Optional[float] = None) -> None:
        ft = self._ft
        ev = MsgEvent("out", "direct", topic, data, ft.node_id)
        if ft.plan.empty and not ft.crash_switch.crashed:
            ft.inner.direct.send(topic, data, timeout_s=timeout_s)
            return
        if ft._suppressed(ev):
            raise TransportError(
                f"fault: {ft.node_id} is crashed/isolated; send to "
                f"{topic!r} suppressed"
            )
        d = ft._sample_delay_s(ev)
        if d > 0:
            time.sleep(d)
        t = ft._roll_tamper(ev)
        payload = data if t is None else t
        for attempt in range(self.DROP_ATTEMPTS):
            if ft._roll_drop(ev) is None:
                ft.inner.direct.send(topic, payload, timeout_s=timeout_s)
                if ft._roll_duplicate(ev):
                    try:
                        ft.inner.direct.send(topic, payload,
                                             timeout_s=timeout_s)
                    except TransportError:
                        pass  # duplicate delivery is best-effort
                ft._maybe_crash_after(ev)
                return
            ft.stats.retry()
            if attempt + 1 < self.DROP_ATTEMPTS:
                time.sleep(self.RETRY_DELAY_S)
        raise TransportError(
            f"fault: direct send to {topic!r} lost "
            f"{self.DROP_ATTEMPTS} consecutive deliveries"
        )

    def listen(self, topic: str, handler: Handler) -> Subscription:
        ft = self._ft
        return _FaultSub(ft.inner.direct.listen(
            topic, ft._wrap_handler("direct", topic, handler)))


class _FaultyQueue(MessageQueue):
    def __init__(self, ft: FaultyTransport):
        self._ft = ft

    def enqueue(self, topic: str, data: bytes, idempotency_key: str = "") -> None:
        ft = self._ft
        ev = MsgEvent("out", "queue", topic, data, ft.node_id)
        if ft.plan.empty and not ft.crash_switch.crashed:
            ft.inner.queues.enqueue(topic, data, idempotency_key)
            return
        if ft._suppressed(ev):
            raise TransportError(
                f"fault: {ft.node_id} is crashed/isolated; enqueue to "
                f"{topic!r} suppressed"
            )
        if ft._roll_drop(ev) is not None:
            return  # lost write — at-least-once producers re-send
        t = ft._roll_tamper(ev)
        payload = data if t is None else t

        def emit():
            ft.inner.queues.enqueue(topic, payload, idempotency_key)
            if ft._roll_duplicate(ev):
                # re-enqueue under the SAME idempotency key: the dedup
                # window must absorb it (and without a key, consumers
                # must tolerate the duplicate)
                ft.inner.queues.enqueue(topic, payload, idempotency_key)

        d = ft._sample_delay_s(ev)
        if d > 0:
            ft._timers.after(d, emit)
        else:
            emit()

    def dequeue(self, topic_filter: str, handler: QueueHandler) -> Subscription:
        ft = self._ft
        return _FaultSub(ft.inner.queues.dequeue(
            topic_filter, ft._wrap_handler("queue", topic_filter, handler)))
