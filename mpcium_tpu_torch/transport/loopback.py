"""In-process loopback fabric: n parties in one process.

The test/bench seam the reference never built (SURVEY.md §4: "in-memory
loopback transport implementing the pub/sub + direct interfaces, n parties
in one process"). One :class:`LoopbackFabric` is shared by all in-process
nodes; each node gets a :class:`Transport` view of it.

Delivery model: handlers run on a worker-thread pool (the reference spawns
a goroutine per inbound direct message — session.go:278 — precisely so a
handler can perform blocking acked sends without deadlocking the fabric).
Handlers must therefore guard their own state (the protocol layer holds a
per-session lock, like the reference's party mutex, session.go:79).
Topic wildcards: a trailing ``*`` segment matches any suffix (NATS-ish,
enough for the reference's ``mpc.<consumer>.*`` filters).

Durable queue semantics: at-least-once, bounded redelivery with
``max_deliver`` then dead-letter callback (the JetStream
max-deliveries-advisory analogue, timeout_consumer.go:14), idempotent
enqueue via Nats-Msg-Id-style keys (message_queue.go:100-110).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from .api import (
    DeadLetterHandler,
    DirectMessaging,
    Handler,
    MessageQueue,
    Permanent,
    PubSub,
    QueueConfig,
    Subscription,
    Transport,
    TransportError,
)


def topic_matches(pattern: str, topic: str) -> bool:
    if pattern == topic:
        return True
    if pattern.endswith("*"):
        return topic.startswith(pattern[:-1])
    return False


@dataclass
class _Sub(Subscription):
    fabric: "LoopbackFabric"
    kind: str
    pattern: str
    handler: Callable
    active: bool = True

    def unsubscribe(self) -> None:
        self.active = False
        with self.fabric._lock:
            subs = self.fabric._subs[self.kind].get(self.pattern, [])
            if self in subs:
                subs.remove(self)


class LoopbackFabric:
    """The shared in-process bus."""

    def __init__(
        self, queue_config: QueueConfig = QueueConfig(), workers: int = 16
    ):
        from concurrent.futures import ThreadPoolExecutor

        self._lock = threading.RLock()
        self._subs: Dict[str, Dict[str, List[_Sub]]] = {
            "pubsub": defaultdict(list),
            "direct": defaultdict(list),
            "queue": defaultdict(list),
        }
        self._queue_config = queue_config
        # idempotency keys live for a bounded window (JetStream's duplicate
        # window semantics): repeats within it are deduped, later legitimate
        # re-submissions (e.g. a second reshare of the same wallet) pass,
        # and the set cannot grow without bound
        self._dedup_window_s = 120.0
        self._seen_msg_ids: Dict[Tuple[str, str], float] = {}
        self._dead_letter: List[DeadLetterHandler] = []
        self._pending_queue_msgs: deque = deque()  # undelivered (no consumer yet)
        self._seq = itertools.count()
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="loopback"
        )
        # queue handlers may block for long periods (e.g. the signing
        # bridge's reply wait) — they get their own pool so they cannot
        # starve protocol pub/sub + direct delivery
        self._qpool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="loopback-q"
        )
        self._inflight = 0
        self._idle = threading.Condition(self._lock)

    # -- lifecycle ----------------------------------------------------------

    def close(self, join_timeout_s: float = 10.0) -> None:
        self._closed = True
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._qpool.shutdown(wait=False, cancel_futures=True)
        # close() is a teardown barrier: the workers must actually be gone
        # when it returns (the soak smoke asserts zero leaked threads), but
        # a handler wedged on a dead peer must not hang close() forever,
        # and a handler that itself triggers close() must not join its own
        # thread — hence the bounded, self-excluding join.
        me = threading.current_thread()
        deadline = time.monotonic() + join_timeout_s
        for pool in (self._pool, self._qpool):
            for t in list(getattr(pool, "_threads", ())):
                if t is me:
                    continue
                t.join(max(0.0, deadline - time.monotonic()))

    def drain(self, timeout_s: float = 60.0) -> None:
        """Block until no handler is in flight (tests)."""
        deadline = time.monotonic() + timeout_s
        with self._idle:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TransportError("loopback fabric did not drain")
                self._idle.wait(remaining)

    # -- dispatch -----------------------------------------------------------

    def _post(self, fn: Callable[[], None], blocking: bool = False) -> None:
        if self._closed:
            raise TransportError("fabric closed")
        with self._lock:
            self._inflight += 1

        def run():
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — handler errors are logged
                from ..utils.log import error

                error("loopback handler error", error=repr(e))
            finally:
                with self._idle:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.notify_all()

        (self._qpool if blocking else self._pool).submit(run)

    # -- pub/sub ------------------------------------------------------------

    def publish(self, topic: str, data: bytes) -> None:
        with self._lock:
            targets = [
                s
                for pat, subs in self._subs["pubsub"].items()
                if topic_matches(pat, topic)
                for s in subs
                if s.active
            ]
        for s in targets:
            self._post(lambda s=s: s.active and s.handler(data))

    def subscribe(self, pattern: str, handler: Handler, kind: str = "pubsub") -> _Sub:
        sub = _Sub(self, kind, pattern, handler)
        with self._lock:
            self._subs[kind][pattern].append(sub)
        if kind == "queue":
            self._flush_pending()
        return sub

    # -- direct (acked unicast) ---------------------------------------------

    def direct_send(self, topic: str, data: bytes, timeout_s: float = 3.0,
                    attempts: int = 3, retry_delay_s: float = 0.05) -> None:
        """Acked unicast. Each attempt posts ONE delivery and waits its
        full per-attempt budget for the ack — a slow (busy) receiver is
        waited on, never re-delivered, so a loaded system cannot amplify
        one message into a queue-flooding stream of duplicates. Re-posts
        happen only when the delivery ERRORED or no subscriber existed."""
        deadline = time.monotonic() + timeout_s * attempts
        deliveries = 0
        while True:
            done = threading.Event()
            err: List[BaseException] = []
            with self._lock:
                targets = [
                    s
                    for pat, subs in self._subs["direct"].items()
                    if topic_matches(pat, topic)
                    for s in subs
                    if s.active
                ]
            if targets:
                def run(s=targets[0]):
                    try:
                        s.handler(data)
                    except BaseException as e:  # noqa: BLE001
                        err.append(e)
                    finally:
                        done.set()

                deliveries += 1
                self._post(run)
                # wait for THIS delivery until the overall deadline
                if done.wait(max(0.0, deadline - time.monotonic())) and not err:
                    return  # acked
                if not done.is_set():
                    # still undelivered at the deadline: give the in-flight
                    # handler no duplicate sibling — just report
                    raise TransportError(
                        f"direct send to {topic!r} not acked after "
                        f"{deliveries} deliveries"
                    )
                if err and deliveries >= max(attempts, 3):
                    # handler keeps ERRORING: bounded re-delivery, never a
                    # deadline-long 50 ms re-post storm
                    raise TransportError(
                        f"direct send to {topic!r} not acked after "
                        f"{deliveries} deliveries"
                    )
            if time.monotonic() >= deadline:
                raise TransportError(
                    f"direct send to {topic!r} not acked after "
                    f"{deliveries} deliveries"
                )
            time.sleep(retry_delay_s)

    # -- durable queues -----------------------------------------------------

    def enqueue(self, topic: str, data: bytes, idempotency_key: str = "") -> None:
        if idempotency_key:
            with self._lock:
                now = time.monotonic()
                key = (topic.rsplit(".", 1)[0], idempotency_key)
                self._seen_msg_ids = {
                    k: t
                    for k, t in self._seen_msg_ids.items()
                    if now - t < self._dedup_window_s
                }
                if key in self._seen_msg_ids:
                    return  # deduped (Nats-Msg-Id semantics)
                self._seen_msg_ids[key] = now
        self._deliver_queue_msg(topic, data, deliveries=0)

    def _deliver_queue_msg(self, topic: str, data: bytes, deliveries: int) -> None:
        with self._lock:
            targets = [
                s
                for pat, subs in self._subs["queue"].items()
                if topic_matches(pat, topic)
                for s in subs
                if s.active
            ]
        if not targets:
            with self._lock:
                self._pending_queue_msgs.append((topic, data, deliveries))
            return
        target = targets[next(self._seq) % len(targets)]  # work-queue balance

        def run():
            n = deliveries + 1
            try:
                target.handler(data)
            except Permanent:
                return  # terminated, no redelivery
            except Exception:  # noqa: BLE001 — nak ⇒ redelivery
                if n >= self._queue_config.max_deliver:
                    self._fire_dead_letter(topic, data, n)
                else:
                    self._deliver_queue_msg(topic, data, n)

        self._post(run, blocking=True)

    def _flush_pending(self) -> None:
        with self._lock:
            pending, self._pending_queue_msgs = (
                list(self._pending_queue_msgs),
                deque(),
            )
        for topic, data, deliveries in pending:
            self._deliver_queue_msg(topic, data, deliveries)

    def _fire_dead_letter(self, topic: str, data: bytes, deliveries: int) -> None:
        with self._lock:
            handlers = list(self._dead_letter)
        for h in handlers:
            self._post(lambda h=h: h(topic, data, deliveries))

    def add_dead_letter_handler(self, handler: DeadLetterHandler) -> None:
        with self._lock:
            self._dead_letter.append(handler)

    # -- node-facing views --------------------------------------------------

    def transport(self) -> Transport:
        fabric = self

        class _PS(PubSub):
            def publish(self, topic, data):
                fabric.publish(topic, data)

            def publish_with_reply(self, topic, reply_topic, data):
                import json

                wrapped = json.dumps(
                    {"reply": reply_topic, "data": data.hex()}
                ).encode()
                fabric.publish(topic, wrapped)

            def subscribe(self, topic, handler):
                return fabric.subscribe(topic, handler, kind="pubsub")

        class _DM(DirectMessaging):
            def send(self, topic, data, timeout_s=None):
                if timeout_s is None:
                    fabric.direct_send(topic, data)
                else:
                    fabric.direct_send(
                        topic, data, timeout_s=timeout_s, attempts=1
                    )

            def listen(self, topic, handler):
                return fabric.subscribe(topic, handler, kind="direct")

        class _MQ(MessageQueue):
            def enqueue(self, topic, data, idempotency_key=""):
                fabric.enqueue(topic, data, idempotency_key)

            def dequeue(self, topic_filter, handler):
                return fabric.subscribe(topic_filter, handler, kind="queue")

        return Transport(
            pubsub=_PS(),
            direct=_DM(),
            queues=_MQ(),
            set_dead_letter_handler=fabric.add_dead_letter_handler,
        )
