"""Transport interfaces — the four delivery semantics of the reference's
NATS fabric (SURVEY.md §5.8):

1. ephemeral pub/sub         (protocol broadcasts, command fan-out)
2. acked unicast with retry  (protocol round unicasts; point2point.go)
3. durable idempotent queues (signing ingestion + results; message_queue.go)
4. dead-letter signaling     (max-deliveries → timeout events)

Implementations: :mod:`.loopback` (in-process test/bench fabric — the seam
the reference never built, SURVEY.md §4) and :mod:`.tcp` (multi-process).
All handlers receive raw ``bytes``.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Optional

Handler = Callable[[bytes], None]
# queue handler returns: None/ACK_OK → ack; raising → retry (nak);
# raising Permanent → terminate (no redelivery)
QueueHandler = Callable[[bytes], Optional[str]]


class Permanent(Exception):
    """Queue handler verdict: do not redeliver (reference ErrPermament,
    message_queue.go:16)."""


class Subscription(abc.ABC):
    @abc.abstractmethod
    def unsubscribe(self) -> None: ...


class PubSub(abc.ABC):
    """Reference messaging.PubSub (pubsub.go:18-72)."""

    @abc.abstractmethod
    def publish(self, topic: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def publish_with_reply(self, topic: str, reply_topic: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def subscribe(self, topic: str, handler: Handler) -> Subscription: ...


class DirectMessaging(abc.ABC):
    """Reference messaging.DirectMessaging (point2point.go:11-14): acked
    request/reply unicast with bounded retry."""

    @abc.abstractmethod
    def send(self, topic: str, data: bytes, timeout_s: Optional[float] = None) -> None:
        """Blocks until the receiver acks; raises TransportError after the
        retry budget (reference default: 3 s timeout × 3 attempts, 50 ms
        delay). ``timeout_s`` overrides the TOTAL budget with a single
        long-wait delivery — the caller's statement that a slow receiver
        is busy, not gone (batched rounds can compute for minutes), and
        must not be re-delivered to."""

    @abc.abstractmethod
    def listen(self, topic: str, handler: Handler) -> Subscription: ...


@dataclass
class QueueConfig:
    """Durable queue behavior knobs (reference message_queue.go:80-89 +
    pubsub.go:225-234)."""

    max_deliver: int = 3
    ack_wait_s: float = 30.0


class MessageQueue(abc.ABC):
    """Reference messaging.MessageQueue (message_queue.go:17-21): durable
    work queue with idempotent publish and bounded redelivery."""

    @abc.abstractmethod
    def enqueue(self, topic: str, data: bytes, idempotency_key: str = "") -> None: ...

    @abc.abstractmethod
    def dequeue(self, topic_filter: str, handler: QueueHandler) -> Subscription:
        """Deliver matching messages; handler raising ⇒ redelivery up to
        max_deliver, then dead-letter."""


DeadLetterHandler = Callable[[str, bytes, int], None]  # (topic, data, deliveries)


class TransportError(Exception):
    pass


@dataclass
class Transport:
    """Bundle handed to the node: the full fabric."""

    pubsub: PubSub
    direct: DirectMessaging
    queues: MessageQueue
    set_dead_letter_handler: Callable[[DeadLetterHandler], None] = field(
        default=lambda h: None
    )
