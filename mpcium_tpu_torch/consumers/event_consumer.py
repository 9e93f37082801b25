"""Event consumers — the node's application brain (reference
pkg/eventconsumer/event_consumer.go).

Subscribes to the three command topics, verifies initiator signatures,
spawns sessions, publishes results:

- keygen: one wallet-creation event drives BOTH curves' DKG concurrently;
  a single KeygenSuccessEvent carries both pubkeys (event_consumer.go:
  103-204).
- signing: dup-session check on walletID-txID (event_consumer.go:234-238),
  NotEnoughParticipants ⇒ raise for queue redelivery (276-280), success ⇒
  idempotent result enqueue + reply-inbox publish (327-337), failure ⇒
  error result event.
- resharing: one dual-role resharing session per node, result aggregated
  (375-518).
- stale-session GC (default 30 min timeout / 5 min sweep,
  event_consumer.go:71-72).

The port's copy of the JAX package's ``consumers/event_consumer.py``.
``device`` reaches the batch scheduler, which builds every batched party
on it (``None``: the GPU, raising when there is none). ``health()``
reports what the JAX version reports, with the port's compile ledger
(K0's build and its launch counters) in place of the XLA one; the claims
ledger of measurement debt is not ported (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import json
import threading
import time
from types import SimpleNamespace
from typing import Dict, Optional

from .. import wire
from ..device import DeviceLike, resolve
from ..node.node import Node, NotEnoughParticipants
from ..node.session import RetryableSessionError
from ..transport.api import Transport
from ..utils import log

SESSION_TIMEOUT_S = 30 * 60  # event_consumer.go:71
GC_INTERVAL_S = 5 * 60  # event_consumer.go:72


class EventConsumer:
    def __init__(
        self,
        node: Node,
        transport: Transport,
        session_timeout_s: float = SESSION_TIMEOUT_S,
        gc_interval_s: float = GC_INTERVAL_S,
        batch_signing: bool = False,
        batch_window_s: float = 0.05,
        metrics=None,
        device: DeviceLike = None,
    ):
        from ..utils.metrics import MetricsRegistry

        self.device = resolve(device)
        self.node = node
        self.transport = transport
        self.session_timeout_s = session_timeout_s
        self.gc_interval_s = gc_interval_s
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._sessions: Dict[str, list] = {}  # dedup key -> [Session]
        self._claim_ts: Dict[str, float] = {}  # dedup key -> claim time
        self._claim_meta: Dict[str, tuple] = {}  # ("sign", msg) for GC
        self._lock = threading.RLock()
        self._subs = []
        self._gc_stop = threading.Event()
        self._gc_thread: Optional[threading.Thread] = None
        self.scheduler = None
        if batch_signing:
            from .batch_scheduler import BatchSigningScheduler

            # requests the scheduler declined (no keyinfo, a share
            # mid-reshare, no GG18 aux, cluster not ready) and sent down the
            # per-session path: the fallback counter does not see them
            self._m_declined = self.metrics.counter("scheduler.declined_total")
            self.scheduler = BatchSigningScheduler(
                node, transport, window_s=batch_window_s,
                metrics=self.metrics, device=self.device,
                on_fallback=self._batch_fallback,
                on_tx_done=lambda w, t: self._finish(f"{w}-{t}"),
                on_tx_released=lambda w, t: self._release(f"{w}-{t}"),
                claim_tx=lambda w, t: self._claim(f"{w}-{t}"),
                on_fallback_keygen=self._keygen_fallback,
                on_kg_done=lambda w: self._finish(f"keygen-{w}"),
                on_kg_released=lambda w: self._release(f"keygen-{w}"),
                claim_kg=lambda w: self._claim(f"keygen-{w}"),
                on_fallback_reshare=self._reshare_fallback,
                on_rs_done=lambda kt, w: self._finish(f"reshare-{kt}-{w}"),
                on_rs_released=lambda kt, w: self._release(f"reshare-{kt}-{w}"),
                claim_rs=lambda kt, w: self._claim(f"reshare-{kt}-{w}"),
            )

    # -- lifecycle ----------------------------------------------------------

    def run(self) -> None:
        ps = self.transport.pubsub
        self._subs.append(ps.subscribe(wire.TOPIC_GENERATE, self._on_generate))
        self._subs.append(ps.subscribe(wire.TOPIC_SIGN, self._on_sign))
        self._subs.append(ps.subscribe(wire.TOPIC_RESHARE, self._on_reshare))
        self._gc_thread = threading.Thread(
            target=self._gc_loop, name=f"session-gc-{self.node.node_id}", daemon=True
        )
        self._gc_thread.start()

    def close(self) -> None:
        self._gc_stop.set()
        if self._gc_thread is not None and self._gc_thread is not threading.current_thread():
            self._gc_thread.join(timeout=5.0)
        if self.scheduler is not None:
            self.scheduler.close()
        for s in self._subs:
            s.unsubscribe()
        with self._lock:
            doomed = [s for ss in self._sessions.values() for s in ss]
            self._sessions.clear()
            self._claim_ts.clear()
            self._claim_meta.clear()
        # close OUTSIDE the lock: closing an unfinished session fires its
        # on_error callback, which may re-enter our bookkeeping
        for s in doomed:
            s.close()

    # -- health surface ------------------------------------------------------

    def health(self) -> dict:
        """JSON-ready operational snapshot: live session/claim counts plus
        every metric in the registry (the scheduler's lane depths, shed
        counters, latency histograms). The daemon publishes this to the
        control plane; LocalCluster aggregates it for tests and soaks."""
        with self._lock:
            live_sessions = sum(len(ss) for ss in self._sessions.values())
            claims = len(self._claim_ts)
        # refresh the observability gauges the snapshot should carry:
        # flight-recorder ring drops, the settled-map size, and the
        # compile ledger with K0's counters (all cheap; health is called
        # at human cadence)
        from ..perf import compile_watch
        from ..trace import recorder

        self.metrics.gauge("trace.dropped_spans").set(
            float(recorder.recorder_for(self.node.node_id).dropped)
        )
        if self.scheduler is not None:
            self.metrics.gauge("scheduler.settled_size").set(
                float(self.scheduler.settled_size())
            )
        compile_watch.export_gauges(self.metrics)
        # measurement debt next to warming state: owed/claimed/stale
        # counts from the claims ledger (cached file reads; the helper
        # never raises — health must not die on a corrupt corpus)
        from ..perf import claims as claims_ledger

        claim_counts = claims_ledger.export_gauges(self.metrics)
        out = {
            "node": self.node.node_id,
            "live_sessions": live_sessions,
            "dedup_claims": claims,
            "batch_signing": self.scheduler is not None,
            "compile": compile_watch.health_summary(),
            "claims": claim_counts,
            "metrics": self.metrics.snapshot(),
        }
        if self.scheduler is not None:
            out["batches_run"] = self.scheduler.batches_run
        return out

    # -- crash recovery (boot-time WAL resume) ------------------------------

    def resume_incomplete(self) -> int:
        """Rebuild every incomplete WAL session at daemon boot: restore the
        party at its last checkpoint, re-attach it to its dedup claim (so
        queue redeliveries of the originating event get a WIP answer instead
        of spawning a conflicting duplicate run), and re-join the wire via
        the session's resume replay. Returns the number of resumed sessions."""
        wal = self.node.session_wal
        if wal is None:
            return 0
        keygen_reps: Dict[str, list] = {}
        others = []
        for rep in wal.incomplete():
            if rep.meta.get("kind") == "keygen":
                # the two curves of one wallet share a dedup claim and a
                # single success event — resume them as a unit
                keygen_reps.setdefault(rep.meta["wallet_id"], []).append(rep)
            else:
                others.append(rep)
        n = 0
        for wallet_id, reps in keygen_reps.items():
            n += self._try_resume(
                reps, lambda: self._resume_keygen(wallet_id, reps)
            )
        for rep in others:
            # the kind tag is routing metadata, not key material — but it
            # rides inside the decrypted WAL record, so declassify the one
            # field we log instead of formatting the record itself
            kind = rep.meta.get("kind")  # mpcflow: declassified — WAL routing tag
            if kind == "sign":
                n += self._try_resume([rep], lambda r=rep: self._resume_sign(r))
            elif kind == "reshare":
                n += self._try_resume(
                    [rep], lambda r=rep: self._resume_reshare(r)
                )
            else:
                log.warn("unknown WAL kind — dropping",
                         session=rep.session_id, kind=kind)
                wal.drop(rep.session_id)
        if n:
            log.info("crash recovery: sessions resumed", node=self.node.node_id,
                     count=n)
        return n

    def _try_resume(self, reps, fn) -> int:
        try:
            return int(bool(fn()))
        except Exception as e:  # noqa: BLE001
            # unresumable (share/keyinfo missing, snapshot mismatch, ...):
            # drop the journal so boot never loops on it; the originating
            # event's redelivery path still provides the retry
            log.warn("session resume failed — dropping WAL",
                     sessions=[r.session_id for r in reps], error=repr(e))
            for r in reps:
                self.node.session_wal.drop(r.session_id)
            return 0

    def _resume_keygen(self, wallet_id: str, reps) -> bool:
        dedup = f"keygen-{wallet_id}"
        if not self._claim(dedup):
            return False
        state = {"left": len(reps)}
        slock = threading.Lock()

        def finalize():
            try:
                infos = {
                    kt: self.node.keyinfo.get(kt, wallet_id)
                    for kt in (wire.KEY_TYPE_SECP256K1, wire.KEY_TYPE_ED25519)
                }
                if all(i is not None and i.public_key for i in infos.values()):
                    ev = wire.KeygenSuccessEvent(
                        wallet_id=wallet_id,
                        ecdsa_pub_key=infos[wire.KEY_TYPE_SECP256K1].public_key,
                        eddsa_pub_key=infos[wire.KEY_TYPE_ED25519].public_key,
                    )
                    self.transport.queues.enqueue(
                        f"{wire.TOPIC_KEYGEN_RESULT}.{wallet_id}",
                        wire.canonical_json(ev.to_json()),
                        idempotency_key=wallet_id,
                    )
                    log.info("wallet created (resumed)", wallet=wallet_id,
                             node=self.node.node_id)
            finally:
                self._finish(dedup)

        def step():
            with slock:
                state["left"] -= 1
                last = state["left"] <= 0
            if last:
                finalize()

        def on_done(_share):
            step()

        def on_error(e):
            log.warn("resumed keygen failed", wallet=wallet_id, error=str(e))
            step()

        sessions = [
            self.node.resume_session(rep, on_done=on_done, on_error=on_error)
            for rep in reps
        ]
        self._track(dedup, sessions)
        for s in sessions:
            s.listen()
        return True

    def _resume_sign(self, rep) -> bool:
        meta = rep.meta
        wallet_id, tx_id = meta["wallet_id"], meta["tx_id"]
        key_type = meta["key_type"]
        nic = meta.get("network_internal_code", "")
        dedup = f"{wallet_id}-{tx_id}"
        fake_msg = SimpleNamespace(
            wallet_id=wallet_id, tx_id=tx_id, network_internal_code=nic
        )
        if not self._claim(dedup, meta=("sign", fake_msg)):
            return False

        def on_done(result):
            try:
                if key_type == wire.KEY_TYPE_SECP256K1:
                    ev = wire.SigningResultEvent(
                        result_type=wire.RESULT_SUCCESS,
                        wallet_id=wallet_id,
                        tx_id=tx_id,
                        network_internal_code=nic,
                        r=format(result["r"], "x"),
                        s=format(result["s"], "x"),
                        signature_recovery=format(result["recovery"], "02x"),
                    )
                else:
                    ev = wire.SigningResultEvent(
                        result_type=wire.RESULT_SUCCESS,
                        wallet_id=wallet_id,
                        tx_id=tx_id,
                        network_internal_code=nic,
                        signature=result.hex(),
                    )
                self.transport.queues.enqueue(
                    f"{wire.TOPIC_SIGNING_RESULT}.{tx_id}",
                    wire.canonical_json(ev.to_json()),
                    idempotency_key=tx_id,
                )
                log.info("tx signed (resumed)", wallet=wallet_id, tx=tx_id,
                         node=self.node.node_id)
            finally:
                self._finish(dedup)

        def on_error(e):
            if not isinstance(e, RetryableSessionError):
                ev = wire.SigningResultEvent(
                    result_type=wire.RESULT_ERROR,
                    wallet_id=wallet_id,
                    tx_id=tx_id,
                    network_internal_code=nic,
                    error_reason=str(e),
                )
                self.transport.queues.enqueue(
                    f"{wire.TOPIC_SIGNING_RESULT}.{tx_id}",
                    wire.canonical_json(ev.to_json()),
                    idempotency_key=tx_id,
                )
            else:
                log.warn("resumed signing retryable failure",
                         wallet=wallet_id, tx=tx_id, reason=str(e))
            self._finish(dedup)

        session = self.node.resume_session(rep, on_done=on_done,
                                           on_error=on_error)
        self._track(dedup, [session])
        session.listen()
        return True

    def _resume_reshare(self, rep) -> bool:
        meta = rep.meta
        wallet_id, key_type = meta["wallet_id"], meta["key_type"]
        new_threshold = meta["new_threshold"]
        dedup = f"reshare-{key_type}-{wallet_id}"
        if not self._claim(dedup):
            return False

        def on_done(share):
            try:
                if share is None:
                    return  # old-only member
                ev = wire.ResharingSuccessEvent(
                    wallet_id=wallet_id,
                    new_threshold=new_threshold,
                    key_type=key_type,
                    pub_key=share.public_key.hex(),
                )
                self.transport.queues.enqueue(
                    f"{wire.TOPIC_RESHARING_RESULT}.{wallet_id}",
                    wire.canonical_json(ev.to_json()),
                    idempotency_key=f"{wallet_id}-{key_type}",
                )
                log.info("wallet reshared (resumed)", wallet=wallet_id,
                         key_type=key_type, node=self.node.node_id)
            finally:
                self._finish(dedup)

        def on_error(e):
            log.error("resumed resharing failed", wallet=wallet_id,
                      error=str(e))
            self._finish(dedup)

        session = self.node.resume_session(rep, on_done=on_done,
                                           on_error=on_error)
        self._track(dedup, [session])
        session.listen()
        return True

    # -- keygen -------------------------------------------------------------

    def _on_generate(self, raw: bytes) -> None:
        try:
            msg = wire.GenerateKeyMessage.from_json(json.loads(raw))
        except Exception as e:  # noqa: BLE001
            log.warn("bad generate event", error=repr(e))
            return
        if not self.node.identity.verify_initiator(msg.raw(), msg.signature):
            log.warn("generate event with BAD initiator signature dropped",
                     wallet=msg.wallet_id)
            return
        wallet_id = msg.wallet_id
        dedup = f"keygen-{wallet_id}"
        if not self._claim(dedup):
            log.info("duplicate keygen event ignored", wallet=wallet_id)
            return
        # batch path: coalesce concurrent wallet creations into one
        # batched-DKG dispatch pair (consumers.batch_scheduler kind="kg")
        if self.scheduler is not None:
            if self.scheduler.submit_keygen(msg):
                return
            self._m_declined.inc()
        self._start_keygen_single(msg, dedup)

    def _keygen_fallback(self, msg) -> None:
        """Scheduler liveness fallback (keygen manifest never arrived):
        per-wallet dual-curve sessions. The dedup claim is still held."""
        self._start_keygen_single(msg, f"keygen-{msg.wallet_id}")

    def _start_keygen_single(self, msg, dedup: str) -> None:
        wallet_id = msg.wallet_id
        threshold = self._threshold()
        results: Dict[str, bytes] = {}
        errors: list = []
        done = threading.Event()

        def mk_done(kt):
            def _done(share):
                results[kt] = share.public_key
                if len(results) == 2:
                    done.set()
            return _done

        def mk_err(kt):
            def _err(e):
                errors.append((kt, e))
                done.set()  # real error propagation, not a hung WaitGroup
                             # (reference wart §7.5: error goroutines never
                             # abort the WaitGroup)
            return _err

        def emit_keygen_error(reason: str):
            ev = wire.KeygenSuccessEvent(
                wallet_id=wallet_id, ecdsa_pub_key="", eddsa_pub_key="",
                result_type=wire.RESULT_ERROR, error_reason=reason,
            )
            self.transport.queues.enqueue(
                f"{wire.TOPIC_KEYGEN_RESULT}.{wallet_id}",
                wire.canonical_json(ev.to_json()),
                idempotency_key=f"{wallet_id}-err",
            )

        try:
            sessions = []
            for kt in (wire.KEY_TYPE_SECP256K1, wire.KEY_TYPE_ED25519):
                s = self.node.create_keygen_session(
                    kt, wallet_id, threshold,
                    on_done=mk_done(kt), on_error=mk_err(kt),
                )
                sessions.append(s)
        except NotEnoughParticipants as e:
            log.warn("keygen: cluster not ready", wallet=wallet_id, error=str(e))
            emit_keygen_error(f"cluster not ready: {e}")
            self._release(dedup)
            return
        self._track(dedup, sessions)
        for s in sessions:
            s.listen()

        def waiter():
            finished = done.wait(self.session_timeout_s)
            try:
                if errors or len(results) != 2:
                    log.error("keygen failed", wallet=wallet_id,
                              errors=repr(errors))
                    reason = (
                        "; ".join(f"{kt}: {e}" for kt, e in errors)
                        if errors
                        else ("timed out" if not finished else "incomplete")
                    )
                    emit_keygen_error(reason)
                    return
                event = wire.KeygenSuccessEvent(
                    wallet_id=wallet_id,
                    ecdsa_pub_key=results[wire.KEY_TYPE_SECP256K1].hex(),
                    eddsa_pub_key=results[wire.KEY_TYPE_ED25519].hex(),
                )
                self.transport.queues.enqueue(
                    f"{wire.TOPIC_KEYGEN_RESULT}.{wallet_id}",
                    wire.canonical_json(event.to_json()),
                    idempotency_key=wallet_id,
                )
                log.info("wallet created", wallet=wallet_id,
                         node=self.node.node_id)
            finally:
                self._finish(dedup)

        threading.Thread(target=waiter, daemon=True).start()

    # -- signing ------------------------------------------------------------

    def _on_sign(self, raw: bytes) -> None:
        """Handles mpc:sign — wrapped by publish_with_reply, so the payload
        carries the reply inbox."""
        try:
            outer = json.loads(raw)
            reply_topic = outer.get("reply", "")
            msg = wire.SignTxMessage.from_json(
                json.loads(bytes.fromhex(outer["data"]))
            )
        except Exception:
            # tolerate un-wrapped direct publishes too
            try:
                msg = wire.SignTxMessage.from_json(json.loads(raw))
                reply_topic = ""
            except Exception as e:  # noqa: BLE001
                log.warn("bad sign event", error=repr(e))
                return
        if not self.node.identity.verify_initiator(msg.raw(), msg.signature):
            log.warn("sign event with BAD initiator signature dropped",
                     wallet=msg.wallet_id, tx=msg.tx_id)
            return
        dedup = f"{msg.wallet_id}-{msg.tx_id}"
        if not self._claim(dedup, meta=("sign", msg)):
            log.info("duplicate signing session ignored", key=dedup)
            # Answer the (fresh) reply inbox anyway: a batched dispatch
            # can legitimately outlive the durable bridge's reply window
            # (a full-size GG18 batch takes minutes), and an unanswered
            # redelivery would march to dead-letter and emit a timeout
            # ERROR for work that is still in flight. A reply means
            # "accepted, in progress" — completion reaches the client
            # through the idempotent result queues, and in-node liveness
            # is the scheduler's/session-GC's job, not redelivery's.
            if reply_topic:
                self.transport.pubsub.publish(reply_topic, b"WIP")
            return
        # batch path: coalesce concurrent requests into one engine
        # dispatch per round (consumers.batch_scheduler); falls back to the
        # per-session path when batching does not apply
        if self.scheduler is not None:
            if self.scheduler.submit(msg, reply_topic):
                return
            self._m_declined.inc()
        self._start_single(msg, reply_topic, dedup)

    def _batch_fallback(self, msg, reply_topic) -> None:
        """Scheduler liveness fallback (manifest never arrived): run the
        request through the normal per-session path. The dedup claim from
        _on_sign is still held."""
        self._start_single(msg, reply_topic, f"{msg.wallet_id}-{msg.tx_id}")

    def _start_single(self, msg, reply_topic: str, dedup: str) -> None:
        def emit_error(reason: str, timeout: bool = False):
            ev = wire.SigningResultEvent(
                result_type=wire.RESULT_ERROR,
                wallet_id=msg.wallet_id,
                tx_id=msg.tx_id,
                network_internal_code=msg.network_internal_code,
                error_reason=reason,
                is_timeout=timeout,
            )
            self.transport.queues.enqueue(
                f"{wire.TOPIC_SIGNING_RESULT}.{msg.tx_id}",
                wire.canonical_json(ev.to_json()),
                idempotency_key=msg.tx_id,
            )
            # terminal error: ack the reply inbox so the durable bridge
            # doesn't burn its full timeout before acking (the reference
            # error path Acks the stream message, event_consumer.go:349-373)
            if reply_topic:
                self.transport.pubsub.publish(reply_topic, b"ERR")

        def on_done(result):
            try:
                if msg.key_type == wire.KEY_TYPE_SECP256K1:
                    ev = wire.SigningResultEvent(
                        result_type=wire.RESULT_SUCCESS,
                        wallet_id=msg.wallet_id,
                        tx_id=msg.tx_id,
                        network_internal_code=msg.network_internal_code,
                        r=format(result["r"], "x"),
                        s=format(result["s"], "x"),
                        signature_recovery=format(result["recovery"], "02x"),
                    )
                else:
                    ev = wire.SigningResultEvent(
                        result_type=wire.RESULT_SUCCESS,
                        wallet_id=msg.wallet_id,
                        tx_id=msg.tx_id,
                        network_internal_code=msg.network_internal_code,
                        signature=result.hex(),
                    )
                self.transport.queues.enqueue(
                    f"{wire.TOPIC_SIGNING_RESULT}.{msg.tx_id}",
                    wire.canonical_json(ev.to_json()),
                    idempotency_key=msg.tx_id,
                )
                if reply_topic:
                    self.transport.pubsub.publish(reply_topic, b"OK")
                log.info("tx signed", wallet=msg.wallet_id, tx=msg.tx_id,
                         node=self.node.node_id)
            finally:
                self._finish(dedup)

        def on_error(e):
            if isinstance(e, RetryableSessionError):
                # e.g. hello-barrier deadline: leave the durable request
                # un-acked (no reply, no result event) so the queue
                # redelivers and a later attempt can gather the quorum
                log.warn("signing retryable failure", wallet=msg.wallet_id,
                         tx=msg.tx_id, reason=str(e))
                self._finish(dedup)
                return
            emit_error(str(e))
            self._finish(dedup)

        try:
            session = self.node.create_signing_session(
                msg.key_type, msg.wallet_id, msg.tx_id, msg.tx,
                on_done=on_done, on_error=on_error,
                network_internal_code=msg.network_internal_code,
            )
        except NotEnoughParticipants as e:
            # no reply ⇒ the durable bridge times out, naks, and the queue
            # redelivers (event_consumer.go:276-280 leaves the event
            # un-acked for exactly this retry)
            log.warn("signing retryable", wallet=msg.wallet_id,
                     tx=msg.tx_id, reason=str(e))
            self._release(dedup)
            return
        except Exception as e:  # noqa: BLE001
            log.error("signing session init failed", error=str(e))
            emit_error(str(e))
            self._release(dedup)
            return
        if session is None:
            # not in quorum — other nodes will sign. Do NOT reply: an early
            # OK would ack the durable request before any quorum node has
            # committed, killing the redelivery path when quorum nodes bail
            # retryably.
            self._release(dedup)
            return
        self._track(dedup, [session])
        session.listen()

    # -- resharing ----------------------------------------------------------

    def _on_reshare(self, raw: bytes) -> None:
        try:
            msg = wire.ResharingMessage.from_json(json.loads(raw))
        except Exception as e:  # noqa: BLE001
            log.warn("bad reshare event", error=repr(e))
            return
        if not self.node.identity.verify_initiator(msg.raw(), msg.signature):
            log.warn("reshare event with BAD initiator signature dropped",
                     wallet=msg.wallet_id)
            return
        dedup = f"reshare-{msg.key_type}-{msg.wallet_id}"
        if not self._claim(dedup):
            return
        # batch path: coalesce concurrent rotations of one topology
        # into a single batched re-deal (consumers.batch_scheduler "rs")
        if self.scheduler is not None:
            if self.scheduler.submit_reshare(msg):
                return
            self._m_declined.inc()
        self._start_reshare_single(msg, dedup)

    def _reshare_fallback(self, msg) -> None:
        """Scheduler liveness fallback (reshare manifest never arrived)."""
        self._start_reshare_single(
            msg, f"reshare-{msg.key_type}-{msg.wallet_id}"
        )

    def _start_reshare_single(self, msg, dedup: str) -> None:
        def on_done(share):
            try:
                if share is None:
                    return  # old-only member
                ev = wire.ResharingSuccessEvent(
                    wallet_id=msg.wallet_id,
                    new_threshold=msg.new_threshold,
                    key_type=msg.key_type,
                    pub_key=share.public_key.hex(),
                )
                self.transport.queues.enqueue(
                    f"{wire.TOPIC_RESHARING_RESULT}.{msg.wallet_id}",
                    wire.canonical_json(ev.to_json()),
                    idempotency_key=f"{msg.wallet_id}-{msg.key_type}",
                )
                log.info("wallet reshared", wallet=msg.wallet_id,
                         key_type=msg.key_type, node=self.node.node_id)
            finally:
                self._finish(dedup)

        def emit_reshare_error(reason: str):
            ev = wire.ResharingSuccessEvent(
                wallet_id=msg.wallet_id, new_threshold=msg.new_threshold,
                key_type=msg.key_type, pub_key="",
                result_type=wire.RESULT_ERROR, error_reason=reason,
            )
            self.transport.queues.enqueue(
                f"{wire.TOPIC_RESHARING_RESULT}.{msg.wallet_id}",
                wire.canonical_json(ev.to_json()),
                idempotency_key=f"{msg.wallet_id}-{msg.key_type}-err",
            )

        def on_error(e):
            log.error("resharing failed", wallet=msg.wallet_id, error=str(e))
            emit_reshare_error(str(e))
            self._finish(dedup)

        try:
            session = self.node.create_resharing_session(
                msg.key_type, msg.wallet_id, msg.new_threshold,
                on_done=on_done, on_error=on_error,
            )
        except NotEnoughParticipants as e:
            # mpc:reshare is an ephemeral command (no durable retry path,
            # matching the reference) — surface a terminal error event so
            # the initiator is not left waiting
            log.warn("resharing: not enough participants", error=str(e))
            emit_reshare_error(str(e))
            self._release(dedup)
            return
        except Exception as e:  # noqa: BLE001
            log.error("resharing session init failed", error=str(e))
            emit_reshare_error(str(e))
            self._release(dedup)
            return
        self._track(dedup, [session])
        session.listen()

    # -- session bookkeeping (event_consumer.go:49-53, 550-573) -------------

    def _claim(self, key: str, meta=None) -> bool:
        with self._lock:
            if key in self._sessions:
                return False
            self._sessions[key] = []
            self._claim_ts[key] = time.monotonic()
            if meta is not None:
                self._claim_meta[key] = meta
            return True

    def _track(self, key: str, sessions) -> None:
        with self._lock:
            self._sessions[key] = list(sessions)

    def _release(self, key: str) -> None:
        with self._lock:
            self._sessions.pop(key, None)
            self._claim_ts.pop(key, None)
            self._claim_meta.pop(key, None)

    def _finish(self, key: str) -> None:
        with self._lock:
            sessions = self._sessions.pop(key, [])
            self._claim_ts.pop(key, None)
            self._claim_meta.pop(key, None)
        for s in sessions:
            s.close()

    def _threshold(self) -> int:
        from ..config import get_config

        return get_config().mpc_threshold

    # -- GC (event_consumer.go:520-547) -------------------------------------

    def _gc_loop(self) -> None:
        while not self._gc_stop.wait(self.gc_interval_s):
            now = time.monotonic()
            stale = []
            # session-less claims (scheduler-owned or the _claim→_track
            # window) reap only when aged out AND the scheduler disowns
            # them — an unreaped empty claim would answer WIP to every
            # redelivery forever, but a live full-size batch
            # legitimately outlives session_timeout_s. The scheduler
            # query happens OUTSIDE our lock: scheduler paths call our
            # release callbacks while holding THEIR lock, so querying
            # owns_dedup under ours would be an ABBA deadlock.
            with self._lock:
                aged_empty = [
                    key for key, sessions in self._sessions.items()
                    if not sessions
                    and now - self._claim_ts.get(key, now)
                    > self.session_timeout_s
                ]
            disowned = {
                key for key in aged_empty
                if not (self.scheduler is not None
                        and self.scheduler.owns_dedup(key))
            }
            with self._lock:
                for key, sessions in list(self._sessions.items()):
                    if sessions:
                        reap = any(
                            now - s.last_activity > self.session_timeout_s
                            for s in sessions
                        )
                    else:
                        # re-check under the lock: the claim must still
                        # be present, session-less, disowned, AND still
                        # aged — during the out-of-lock owns_dedup query
                        # the claim may have been released and freshly
                        # re-claimed by a redelivery; its new _claim_ts
                        # fails the age test and spares it
                        reap = (
                            key in disowned
                            and now - self._claim_ts.get(key, now)
                            > self.session_timeout_s
                        )
                    if reap:
                        stale.append((key, self._claim_meta.get(key), sessions))
                        self._sessions.pop(key, None)
                        self._claim_ts.pop(key, None)
                        self._claim_meta.pop(key, None)
            for key, meta, sessions in stale:
                # close OUTSIDE the lock: an unfinished session's close
                # fires on_error, which re-enters our bookkeeping
                for s in sessions:
                    s.close()
                log.warn("stale session reaped", key=key,
                         node=self.node.node_id)
                # a reaped SIGNING claim must surface to the client: WIP
                # replies have been acking its redeliveries, so without
                # this terminal event the dead-letter path never fires
                # and the client hangs forever
                if meta is not None and meta[0] == "sign":
                    msg = meta[1]
                    ev = wire.SigningResultEvent(
                        result_type=wire.RESULT_ERROR,
                        wallet_id=msg.wallet_id,
                        tx_id=msg.tx_id,
                        network_internal_code=msg.network_internal_code,
                        error_reason="signing session reaped after "
                        "inactivity timeout",
                        is_timeout=True,
                    )
                    try:
                        self.transport.queues.enqueue(
                            f"{wire.TOPIC_SIGNING_RESULT}.{msg.tx_id}",
                            wire.canonical_json(ev.to_json()),
                            idempotency_key=msg.tx_id,
                        )
                    except Exception as e:  # noqa: BLE001
                        log.warn("reap result emit failed", error=repr(e))
