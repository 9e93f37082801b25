"""Durable signing ingestion bridge (reference sign_consumer.go).

Consumes the durable signing-request queue, re-publishes each event on the
ephemeral ``mpc:sign`` topic with a fresh reply inbox, and waits for a
reply: reply ⇒ ack; timeout ⇒ raise (nak → queue redelivery, up to
max_deliver, then dead-letter → timeout consumer).

A reply means "accepted and in progress", not "complete": consumers
answer OK/ERR on terminal outcomes and WIP when a redelivered request is
already claimed by a live session or batch (batched full-size GG18 runs
far outlive the reply window; an unanswered redelivery would dead-letter
work still in flight). Results always travel the idempotent result
queues, never the inbox."""
from __future__ import annotations

import threading
import uuid

from .. import wire
from ..transport.api import Transport
from ..utils import log

REPLY_TIMEOUT_S = 30.0  # sign_consumer.go:16-20


class SigningConsumer:
    def __init__(self, transport: Transport, reply_timeout_s: float = REPLY_TIMEOUT_S):
        self.transport = transport
        self.reply_timeout_s = reply_timeout_s
        self._sub = None

    def run(self) -> None:
        self._sub = self.transport.queues.dequeue(
            wire.TOPIC_SIGNING_REQUEST, self._handle
        )

    def close(self) -> None:
        if self._sub:
            self._sub.unsubscribe()

    def _handle(self, data: bytes) -> None:
        """One delivery: publish on mpc:sign with a fresh inbox, wait one
        reply window. Any reply acks the durable message — including WIP
        from a claim holder still batching (terminal results travel the
        idempotent result queues, and an in-process failure later is
        surfaced by the consumer GC's reap-with-error). Known tradeoff:
        if the claim-holding PROCESS dies after a WIP ack, the request is
        gone from the queue and the client learns via its own timeout
        rather than an explicit event — the bound is the client timeout,
        same as the reference's initiator-side budget."""
        reply_topic = f"_inbox.{uuid.uuid4().hex}"
        got_reply = threading.Event()
        sub = self.transport.pubsub.subscribe(
            reply_topic, lambda _d: got_reply.set()
        )
        try:
            self.transport.pubsub.publish_with_reply(
                wire.TOPIC_SIGN, reply_topic, data
            )
            if not got_reply.wait(self.reply_timeout_s):
                log.warn("signing request timed out waiting for reply")
                raise TimeoutError("no signing reply")  # nak ⇒ redelivery
        finally:
            sub.unsubscribe()


class TimeoutConsumer:
    """Dead-letter → client error event (reference timeout_consumer.go):
    when a signing request exhausts its deliveries, synthesize
    SigningResultEvent{error, is_timeout} so the client learns of the
    failure instead of waiting forever."""

    def __init__(self, transport: Transport):
        self.transport = transport

    def run(self) -> None:
        self.transport.set_dead_letter_handler(self._on_dead_letter)

    def _on_dead_letter(self, topic: str, data: bytes, deliveries: int) -> None:
        if not topic.startswith(wire.TOPIC_SIGNING_REQUEST):
            return
        import json

        try:
            msg = wire.SignTxMessage.from_json(json.loads(data))
        except Exception as e:  # noqa: BLE001
            log.warn("dead-letter with undecodable payload", error=repr(e))
            return
        ev = wire.SigningResultEvent(
            result_type=wire.RESULT_ERROR,
            wallet_id=msg.wallet_id,
            tx_id=msg.tx_id,
            network_internal_code=msg.network_internal_code,
            error_reason=f"signing request exhausted {deliveries} deliveries",
            is_timeout=True,
        )
        self.transport.queues.enqueue(
            f"{wire.TOPIC_SIGNING_RESULT}.{msg.tx_id}",
            wire.canonical_json(ev.to_json()),
            idempotency_key=msg.tx_id,
        )
        log.warn("signing request dead-lettered", wallet=msg.wallet_id,
                 tx=msg.tx_id, deliveries=deliveries)
