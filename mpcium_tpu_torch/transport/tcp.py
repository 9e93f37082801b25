"""TCP message bus: the multi-process NATS equivalent.

One :class:`BrokerServer` (the `nats-server` analogue from the reference's
docker-compose) + per-process :class:`TcpTransport` clients implementing
the same four delivery semantics as the loopback fabric:

- pub/sub fan-out (with trailing-``*`` patterns)
- acked unicast: the broker routes to one listener and relays the ack;
  the sender retries on timeout (reference point2point.go budgets)
- durable queues: broker-held state — pending buffering, Nats-Msg-Id
  idempotency, per-message delivery counts, redelivery on nak/disconnect,
  dead-letter broadcast after max_deliver
- dead-letter events fan out to every connected client that registered

Durability: ``journal_path`` gives the broker an append-only JSONL journal
of queue state (enqueue / done records). A restarted broker replays it and
redelivers every enqueued-but-unacked message — the reference's file-backed
JetStream WorkQueue retention (message_queue.go:56-63). Pub/sub and direct
traffic stay ephemeral, as in NATS core.

Auth: ``auth_token`` requires every client's first frame to be
``{"op": "auth", "token": ...}`` — the reference's NATS user/password
credentials (main.go:346-359, config.prod.yaml.template). The broker
stores and compares only the SHA-256 of the token (constant-time), so
config files can hold ``sha256:<hex>`` instead of the secret (the digest
is still a full credential for this broker — see SECURITY.md).

Encryption: ``encrypt=True`` wraps every connection in the AEAD channel
of :mod:`.secure` (X25519 ephemerals + token-bound HKDF +
ChaCha20-Poly1305 with per-direction counter nonces) — the equivalent of
the reference's production TLS-to-NATS posture, with mutual
authentication riding the shared token instead of certificates.

High availability: the reference clusters NATS (and JetStream replicates
streams); here a second broker started with ``follow=(host, port)`` runs
as a **hot standby** — it attaches to the primary over the same
authenticated/encrypted channel, snapshots every not-yet-done queue
message, then mirrors the live enqueue/done stream into its own journal.
Clients list both endpoints (``TcpClient(addrs=[primary, standby] )`` /
config ``broker_standbys``): when the primary dies they transparently
reconnect down the list, re-authenticate, and replay their
subscriptions, and the standby serves the mirrored backlog. Semantics
across a failover are NATS-like: durable queues are at-least-once
(consumers are idempotent; the dedup window does not replicate for
snapshot entries), pub/sub and direct traffic are ephemeral (app-level
acks/retries cover the gap). Split-brain is bounded by the address-list
ordering — clients prefer the primary while it is reachable — and there
is no automatic fail-back: re-arming HA after an outage means restarting
the dead broker as the new standby (runbook in INSTALLATION.md).

The port's copy of the JAX package's ``transport/tcp.py``: the same
frames, journal records and handshake byte for byte, so a JAX client
works against a port broker and the reverse; :func:`tcp_transport` also
takes the size of the client's handler pools.

Framing: newline-delimited JSON, payloads hex-encoded. This is a dev/ops
fabric for single-digit node counts (the reference's deployment shape);
protocol payload sizes are small (keygen/signing round messages).
"""
from __future__ import annotations


import itertools
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

try:
    from cryptography.exceptions import InvalidTag as _InvalidTag
except ImportError:  # bare env: softcrypto's AEAD raises its own InvalidTag
    from ..core.softcrypto import InvalidTag as _InvalidTag

from .api import (
    DeadLetterHandler,
    DirectMessaging,
    Handler,
    MessageQueue,
    Permanent,
    PubSub,
    QueueConfig,
    QueueHandler,
    Subscription,
    Transport,
    TransportError,
)
from .loopback import topic_matches
from ..utils import log


def _send_frame(sock: socket.socket, obj: dict, cipher=None) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    if cipher is not None:
        data = cipher.encrypt(data).hex().encode()
    sock.sendall(data + b"\n")


def _recv_line_blocking(sock: socket.socket, timeout_s: float = 10.0) -> bytes:
    """Read one newline-terminated line (handshake only — before the
    read loop starts)."""
    sock.settimeout(timeout_s)
    buf = b""
    try:
        while b"\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                raise TransportError("connection closed during handshake")
            buf += chunk
    finally:
        sock.settimeout(None)
    line, _rest = buf.split(b"\n", 1)
    # handshake is strictly one line each way before any other traffic, so
    # _rest is empty by protocol
    return line


class _Conn:
    """Broker-side client connection."""

    def __init__(self, sock: socket.socket, broker: "BrokerServer", cid: int):
        self.sock = sock
        self.broker = broker
        self.cid = cid
        self.subs: Dict[int, Tuple[str, str]] = {}  # sid -> (kind, pattern)
        self.is_replica = False  # a standby broker following this one
        self.wants_dead_letters = False
        self.lock = threading.Lock()
        self.alive = True
        self.authed = False
        self.cipher = None  # set by the broker's handshake when encrypting

    def send(self, obj: dict) -> bool:
        try:
            with self.lock:
                _send_frame(self.sock, obj, self.cipher)
            return True
        except OSError:
            self.alive = False
            return False


class BrokerServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        queue_config: QueueConfig = QueueConfig(),
        journal_path: Optional[str] = None,
        auth_token: Optional[str] = None,
        journal_fsync: bool = True,
        encrypt: bool = False,
        follow: Optional[Tuple[str, int]] = None,
        queue_ttl_s: float = 1800.0,
    ):
        from .secure import hash_token

        self.queue_config = queue_config
        # stored hashed (sha256:<hex>): comparisons are digest-vs-digest,
        # and configs may carry the digest instead of the secret
        self.auth_token = None if auth_token is None else hash_token(auth_token)
        self.encrypt = encrypt
        if encrypt and auth_token is None:
            raise ValueError(
                "encrypt=True requires an auth token (the AEAD channel's "
                "mutual authentication is token-bound)"
            )
        # fsync acked enqueues (host-crash durability); opt out for tests /
        # throwaway brokers where the per-enqueue fsync cost matters
        self._journal_fsync = journal_fsync
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()
        self._conns: Dict[int, _Conn] = {}
        self._lock = threading.RLock()
        self._cid = itertools.count(1)
        self._did = itertools.count(1)
        self._rr = itertools.count()
        # bounded dedup window (JetStream duplicate-window semantics)
        self._dedup_window_s = 120.0
        self._seen_ids: Dict[Tuple[str, str], float] = {}
        self._pending_q: deque = deque()  # (topic, data, deliveries, mid)
        self._pending_mids: Set[int] = set()  # mirror of _pending_q mids
        # Work-queue TTL: per-tx/per-wallet RESULT topics mean a result
        # published after its (sole) requester timed out and unsubscribed
        # has no consumer, is never nak'd, and would otherwise pend — in
        # memory, the journal, and every standby — forever. Expired
        # messages take the dead-letter path. mid -> first-enqueue WALL
        # time (wall, not monotonic: the stamp is journaled and
        # replicated, so the age survives restarts and standby
        # promotion); redeliveries keep the original stamp. A sweep
        # thread expires the backlog even on a quiet broker with no new
        # subscriptions to trigger a dispatch.
        self.queue_ttl_s = queue_ttl_s
        self._enq_ts: Dict[int, float] = {}
        # Control-plane KV served over the wire (the Consul analogue —
        # reference pkg/infra/consul.go serves registry/keyinfo/peers over
        # HTTP(S)+ACL; here the broker IS the network rendezvous, so the
        # same socket carries the control plane). Durable keys are
        # journaled (fsync'd) and replicated to standbys; transient keys
        # (registry liveness heartbeats at 1 Hz) are neither — after a
        # failover the nodes' heartbeat loops repopulate them within a
        # poll period. Values are hex strings (JSON-frame safe).
        self._kv: Dict[str, str] = {}
        self._kv_transient: Set[str] = set()
        self._inflight: Dict[int, Tuple[str, str, int, int, int]] = {}
        # did -> (topic, data, deliveries, cid, mid)
        self._mid_next = 1  # next mid (plain int: replication bumps it)
        self._journal = None
        self._jlock = threading.Lock()
        if journal_path is not None:
            self._replay_journal(journal_path)
            self._journal = open(journal_path, "a", buffering=1)
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="broker-accept", daemon=True
        )
        self._accept_thread.start()
        if queue_ttl_s > 0:
            threading.Thread(
                target=self._ttl_sweep_loop, name="broker-ttl-sweep",
                daemon=True,
            ).start()
        # -- standby mode: follow a primary's queue state until it dies ----
        # (see the "High availability" section of the module docstring)
        self._follow = follow
        self._follower_cli: Optional["TcpClient"] = None
        self._rep_synced = threading.Event()
        if follow is not None:
            threading.Thread(
                target=self._follow_loop, name="broker-follow", daemon=True
            ).start()

    # -- durability ---------------------------------------------------------

    def _replay_journal(self, path: str) -> None:
        """Rebuild pending queue state from the append-only journal, then
        compact it (pending survivors only). Enqueued-but-not-done messages
        are redelivered once a consumer subscribes — the reference's
        file-backed WorkQueue retention (message_queue.go:56-63)."""
        pending: Dict[int, Tuple[str, str, str, float]] = {}
        max_mid = 0
        if os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail write on crash
                    if rec.get("j") == "enq":
                        pending[rec["mid"]] = (
                            rec["topic"], rec["data"], rec.get("key", ""),
                            # wall-clock enqueue stamp: the TTL age
                            # survives restarts (pre-stamp journals age
                            # from replay time)
                            float(rec.get("ts", time.time())),
                        )
                        max_mid = max(max_mid, rec["mid"])
                    elif rec.get("j") == "done":
                        pending.pop(rec["mid"], None)
                    elif rec.get("j") == "kvp":
                        self._kv[rec["k"]] = rec["v"]
                    elif rec.get("j") == "kvd":
                        self._kv.pop(rec["k"], None)
        self._mid_next = max_mid + 1
        tmp = path + ".tmp"
        now = time.monotonic()
        with open(tmp, "w") as fh:
            for mid, (topic, data, key, ts) in sorted(pending.items()):
                fh.write(json.dumps(
                    {"j": "enq", "mid": mid, "topic": topic, "data": data,
                     "key": key, "ts": ts}, separators=(",", ":")) + "\n")
                self._pending_q.append((topic, data, 0, mid))
                self._pending_mids.add(mid)
                self._enq_ts[mid] = ts
                if key:
                    self._seen_ids[(topic.rsplit(".", 1)[0], key)] = now
            for k in sorted(self._kv):
                fh.write(json.dumps(
                    {"j": "kvp", "k": k, "v": self._kv[k]},
                    separators=(",", ":")) + "\n")
        os.replace(tmp, path)

    def _journal_write(self, rec: dict, durable: bool = False) -> None:
        # dedicated journal lock: fsync latency must not serialize the
        # broker's global dispatch lock (pub/sub and direct traffic need no
        # durability and should never stall behind a disk flush)
        with self._jlock:
            # re-check under the lock: close() nulls self._journal while a
            # racing write could otherwise hit a closed file
            j = self._journal
            if j is None:
                return
            j.write(json.dumps(rec, separators=(",", ":")) + "\n")
            if durable and self._journal_fsync:
                j.flush()
                os.fsync(j.fileno())

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self._closed = True
        if self._follower_cli is not None:
            self._follower_cli.close()
        try:
            self._srv.close()
        except OSError:
            pass
        # wake the accept thread: its blocked accept() holds a reference
        # to the listening socket, which otherwise stays in LISTEN and
        # squats the port against a broker restart
        try:
            socket.create_connection((self.host, self.port),
                                     timeout=1).close()
        except OSError:
            pass
        with self._lock:
            for c in self._conns.values():
                try:
                    # shutdown FIRST: close() alone neither wakes the read
                    # thread blocked in recv (whose in-flight syscall keeps
                    # the kernel socket alive, squatting the port against a
                    # restart) nor sends FIN to the peer
                    c.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.sock.close()
                except OSError:
                    pass
        with self._jlock:
            if self._journal is not None:
                self._journal.close()
                self._journal = None

    # -- accept/read --------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            if self._closed:
                try:
                    sock.close()
                finally:
                    return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock, self, next(self._cid))
            with self._lock:
                self._conns[conn.cid] = conn
            threading.Thread(
                target=self._read_loop, args=(conn,),
                name=f"broker-read-{conn.cid}", daemon=True,
            ).start()

    def _handshake(self, conn: _Conn) -> None:
        """Server side of the AEAD channel establishment (secure.py)."""
        from .secure import derive_cipher, fresh_keypair

        hello = json.loads(_recv_line_blocking(conn.sock))
        if hello.get("op") != "ehello":
            raise TransportError("client did not start AEAD handshake")
        client_pub = bytes.fromhex(hello["epub"])
        priv, server_pub = fresh_keypair()
        _send_frame(conn.sock, {"op": "ehello", "epub": server_pub.hex()})
        conn.cipher = derive_cipher(
            priv, client_pub, client_pub, server_pub,
            self.auth_token, is_server=True,
        )

    def _read_loop(self, conn: _Conn) -> None:
        if self.encrypt:
            try:
                self._handshake(conn)
            except Exception as e:  # noqa: BLE001
                log.warn("broker: AEAD handshake failed", error=repr(e))
                self._drop(conn)
                return
        buf = b""
        try:
            while not self._closed:
                chunk = conn.sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line:
                        if conn.cipher is not None:
                            line = conn.cipher.decrypt(
                                bytes.fromhex(line.decode())
                            )
                        self._handle(conn, json.loads(line))
        except (OSError, ValueError, _InvalidTag):
            pass
        finally:
            self._drop(conn)

    def _drop(self, conn: _Conn) -> None:
        conn.alive = False
        with self._lock:
            self._conns.pop(conn.cid, None)
            # redeliver this client's unacked queue messages
            orphaned = [
                (did, v) for did, v in self._inflight.items() if v[3] == conn.cid
            ]
            for did, (topic, data, deliveries, _cid, mid) in orphaned:
                del self._inflight[did]
                self._queue_dispatch(topic, data, deliveries, mid)

    # -- frame handling ------------------------------------------------------

    def _handle(self, conn: _Conn, f: dict) -> None:
        op = f.get("op")
        if self.auth_token is not None and not conn.authed:
            # first frame must authenticate (reference NATS credentials,
            # main.go:346-359); hashed constant-time compare, drop on failure
            from .secure import token_matches

            if op == "auth" and token_matches(
                str(f.get("token", "")), self.auth_token
            ):
                conn.authed = True
                conn.send({"op": "auth_ok"})
            else:
                log.warn("broker: unauthenticated client rejected")
                try:
                    conn.send({"op": "auth_err"})
                    conn.sock.close()
                except OSError:
                    pass
            return
        if op == "auth":
            conn.send({"op": "auth_ok"})  # auth disabled: accept anything
            return
        if op == "sub":
            with self._lock:
                conn.subs[f["sid"]] = (f["kind"], f["pattern"])
            if f["kind"] == "queue":
                self._flush_pending()
        elif op == "unsub":
            with self._lock:
                conn.subs.pop(f["sid"], None)
        elif op == "dead_sub":
            conn.wants_dead_letters = True
        elif op == "pub":
            self._fanout(f["topic"], f["data"], f.get("reply"))
        elif op == "direct":
            self._direct(conn, f)
        elif op == "ack":  # receiver acked a direct message
            self._relay_ack(f)
        elif op == "enqueue":
            key = f.get("key", "")
            if key:
                with self._lock:
                    now = time.monotonic()
                    self._seen_ids = {
                        k: t
                        for k, t in self._seen_ids.items()
                        if now - t < self._dedup_window_s
                    }
                    dk = (f["topic"].rsplit(".", 1)[0], key)
                    if dk in self._seen_ids:
                        return
                    self._seen_ids[dk] = now
            with self._lock:
                mid = self._mid_next
                self._mid_next += 1
                ts = time.time()
                self._enq_ts[mid] = ts
            # enqueues are acknowledged to publishers — fsync (when enabled)
            # so an accepted request survives a host crash, not just a
            # process crash ("done" records may be lost: redelivery of a
            # completed message is the safe direction for a work queue)
            self._journal_write(
                {"j": "enq", "mid": mid, "topic": f["topic"],
                 "data": f["data"], "key": key, "ts": ts},
                durable=True,
            )
            self._queue_dispatch(
                f["topic"], f["data"], 0, mid,
                rep_rec={"j": "enq", "mid": mid, "topic": f["topic"],
                         "data": f["data"], "key": key, "ts": ts},
            )
        elif op == "kvput":
            k, v = f["k"], f["v"]
            transient = bool(f.get("t"))
            # journal + replicate INSIDE the lock: KV mutations of the
            # same key are order-sensitive (unlike queue done records) —
            # a put and a delete racing outside the lock could reach the
            # journal/standbys in the opposite order they were applied,
            # resurrecting a revoked key after failover. Durable KV ops
            # are rare (peers/keyinfo writes); heartbeats are transient
            # and skip this path, so the fsync-under-lock cost is
            # negligible.
            with self._lock:
                self._kv[k] = v
                if transient:
                    self._kv_transient.add(k)
                else:
                    self._kv_transient.discard(k)
                    self._journal_write({"j": "kvp", "k": k, "v": v},
                                        durable=True)
                    self._replicate({"j": "kvp", "k": k, "v": v})
            conn.send({"op": "kvr", "rid": f["rid"], "ok": True})
        elif op == "kvget":
            with self._lock:
                v = self._kv.get(f["k"])
            conn.send({"op": "kvr", "rid": f["rid"], "v": v})
        elif op == "kvdel":
            k = f["k"]
            with self._lock:
                was_transient = k in self._kv_transient
                self._kv.pop(k, None)
                self._kv_transient.discard(k)
                if not was_transient:
                    # durable: a lost delete would resurrect a
                    # deliberately removed control-plane key (e.g. a
                    # revoked peer) — the unsafe direction
                    self._journal_write({"j": "kvd", "k": k}, durable=True)
                    self._replicate({"j": "kvd", "k": k})
            conn.send({"op": "kvr", "rid": f["rid"], "ok": True})
        elif op == "kvkeys":
            p = f.get("p", "")
            with self._lock:
                ks = sorted(k for k in self._kv if k.startswith(p))
            conn.send({"op": "kvr", "rid": f["rid"], "keys": ks})
        elif op == "kvscan":
            # one-round-trip prefix scan: the registry polls liveness at
            # 1 Hz per node; per-key gets would be O(N) RTTs per poll
            p = f.get("p", "")
            with self._lock:
                items = {
                    k: v for k, v in self._kv.items() if k.startswith(p)
                }
            conn.send({"op": "kvr", "rid": f["rid"], "items": items})
        elif op == "qack":
            with self._lock:
                v = self._inflight.pop(f["did"], None)
                if v:
                    self._enq_ts.pop(v[4], None)
            if v:
                self._journal_write({"j": "done", "mid": v[4]})
                self._replicate({"j": "done", "mid": v[4]})
        elif op == "qnak":
            with self._lock:
                v = self._inflight.pop(f["did"], None)
            if v:
                topic, data, deliveries, _cid, mid = v
                if f.get("permanent"):
                    with self._lock:
                        self._enq_ts.pop(mid, None)
                    self._journal_write({"j": "done", "mid": mid})
                    self._replicate({"j": "done", "mid": mid})
                    return
                if deliveries >= self.queue_config.max_deliver:
                    with self._lock:
                        self._enq_ts.pop(mid, None)
                    self._journal_write({"j": "done", "mid": mid})
                    self._replicate({"j": "done", "mid": mid})
                    self._dead_letter(topic, data, deliveries)
                else:
                    self._queue_dispatch(topic, data, deliveries, mid)
        elif op == "replica":
            # a standby broker wants the queue state: snapshot every
            # not-yet-done message (pending + inflight: inflight would be
            # redelivered after a failover anyway — at-least-once). The
            # snapshot is SENT while holding the broker lock: a concurrent
            # qack's live "done" record must not overtake the snapshot
            # "enq" for the same mid (the standby would keep a completed
            # message pending forever). Snapshot size is bounded by the
            # undone backlog; stalling dispatch for its transmission is
            # the price of a consistent cut.
            with self._lock:
                now = time.time()
                snapshot = [
                    {"j": "enq", "mid": mid, "topic": t, "data": d,
                     "ts": self._enq_ts.get(mid, now)}
                    for (t, d, _dl, mid) in self._pending_q
                ] + [
                    {"j": "enq", "mid": v[4], "topic": v[0], "data": v[1],
                     "ts": self._enq_ts.get(v[4], now)}
                    for v in self._inflight.values()
                ]
                kv_snapshot = [
                    {"j": "kvp", "k": k, "v": v}
                    for k, v in sorted(self._kv.items())
                    if k not in self._kv_transient
                ]
                for rec in sorted(snapshot, key=lambda r: r["mid"]):
                    conn.send({"op": "rep", **rec})
                for rec in kv_snapshot:
                    conn.send({"op": "rep", **rec})
                conn.send({"op": "rep", "j": "synced"})
                conn.is_replica = True

    # -- replication (standby brokers) ---------------------------------------

    def _replicate(self, rec: dict) -> None:
        """Stream a queue-journal record to every attached standby."""
        with self._lock:
            reps = [c for c in self._conns.values() if c.is_replica]
        for c in reps:
            c.send({"op": "rep", **rec})

    def _follow_loop(self) -> None:
        """Standby side: attach to the primary, mirror its queue state into
        our own journal/pending set, and keep mirroring. A lost primary
        connection is NOT assumed to be primary death (a transient blip
        must not silently disarm replication): the loop re-attaches and
        re-snapshots forever — the snapshot/stream dedup in
        _apply_replica_record makes re-follows idempotent, and "done"s
        missed during an outage at worst leave already-completed messages
        pending here (redelivery of completed work is the safe direction;
        consumers are idempotent). While the primary is actually down this
        broker simply keeps serving — clients reach it via their address
        lists — so "promotion" needs no state transition at all."""
        host, port = self._follow
        token = self.auth_token  # hashed form authenticates (secure.py)
        attached = False
        while not self._closed:
            try:
                cli = TcpClient(
                    host, port, workers=2, auth_token=token,
                    encrypt=self.encrypt, reconnect=False,
                )
            except (OSError, TransportError):
                if attached:
                    attached = False
                    log.warn(
                        "broker standby: primary unreachable — serving "
                        "active, will re-follow when it returns",
                        primary=f"{host}:{port}",
                    )
                time.sleep(1.0)
                continue
            self._follower_cli = cli
            cli._rep_handler = self._apply_replica_record
            try:
                cli._send({"op": "replica"})
            except TransportError:
                cli.close()
                continue
            attached = True
            log.info("broker standby: following primary",
                     primary=f"{host}:{port}")
            cli._reader.join()  # blocks until the primary connection dies
            cli.close()
            self._follower_cli = None

    def _apply_replica_record(self, rec: dict) -> None:
        j = rec.get("j")
        if j == "synced":
            self._rep_synced.set()
            return
        # Chain replication: forward every applied record to replicas
        # attached to THIS standby (primary <- s1 <- s2 ...), so a second
        # standby stays current after the first one is promoted. The
        # forward happens INSIDE the same critical section that applies
        # the record (the RLock re-enters for _replicate) — forwarding
        # outside it would let a downstream replica cut its snapshot
        # between the forward and the apply and miss the record from
        # both paths.
        if j == "enq":
            mid = rec["mid"]
            topic, data, key = rec["topic"], rec["data"], rec.get("key", "")
            ts = float(rec.get("ts", time.time()))
            with self._lock:
                # local mid counter must stay ahead of replicated ids so
                # post-promotion enqueues never collide
                self._mid_next = max(self._mid_next, mid + 1)
                if mid in self._pending_mids:
                    return  # snapshot/stream or re-follow overlap
                if key:
                    self._seen_ids[(topic.rsplit(".", 1)[0], key)] = (
                        time.monotonic()
                    )
                self._pending_q.append((topic, data, 0, mid))
                self._pending_mids.add(mid)
                self._enq_ts[mid] = ts
                self._replicate(rec)
            self._journal_write(
                {"j": "enq", "mid": mid, "topic": topic, "data": data,
                 "key": key, "ts": ts},
                durable=True,
            )
        elif j == "done":
            with self._lock:
                self._enq_ts.pop(rec["mid"], None)
                if rec["mid"] in self._pending_mids:
                    self._pending_mids.discard(rec["mid"])
                    self._pending_q = deque(
                        e for e in self._pending_q if e[3] != rec["mid"]
                    )
                self._replicate(rec)
            self._journal_write({"j": "done", "mid": rec["mid"]})
        elif j == "kvp":
            with self._lock:
                self._kv[rec["k"]] = rec["v"]
                self._replicate(rec)
            self._journal_write({"j": "kvp", "k": rec["k"], "v": rec["v"]},
                                durable=True)
        elif j == "kvd":
            with self._lock:
                self._kv.pop(rec["k"], None)
                self._replicate(rec)
            # durable like kvput: resurrecting a deliberately deleted
            # control-plane key (a removed peer) is the unsafe direction
            self._journal_write({"j": "kvd", "k": rec["k"]}, durable=True)

    # -- pub/sub -------------------------------------------------------------

    def _fanout(self, topic: str, data_hex: str, reply: Optional[str]) -> None:
        with self._lock:
            targets = [
                (c, sid)
                for c in self._conns.values()
                for sid, (kind, pat) in c.subs.items()
                if kind == "pubsub" and topic_matches(pat, topic)
            ]
        for c, sid in targets:
            c.send({"op": "msg", "sid": sid, "topic": topic, "data": data_hex,
                    "reply": reply})

    # -- direct --------------------------------------------------------------

    def _direct(self, sender: _Conn, f: dict) -> None:
        with self._lock:
            targets = [
                (c, sid)
                for c in self._conns.values()
                for sid, (kind, pat) in c.subs.items()
                if kind == "direct" and topic_matches(pat, f["topic"])
            ]
        if not targets:
            sender.send({"op": "dack", "rid": f["rid"], "ok": False})
            return
        c, sid = targets[0]
        ok = c.send(
            {"op": "dmsg", "sid": sid, "data": f["data"], "rid": f["rid"],
             "from_cid": sender.cid}
        )
        if not ok:
            sender.send({"op": "dack", "rid": f["rid"], "ok": False})

    def _relay_ack(self, f: dict) -> None:
        target_cid = f.get("to_cid")
        with self._lock:
            conn = self._conns.get(target_cid)
        if conn:
            conn.send({"op": "dack", "rid": f["rid"], "ok": bool(f.get("ok", True))})

    # -- queues --------------------------------------------------------------

    def _queue_dispatch(
        self, topic: str, data_hex: str, deliveries: int, mid: int,
        rep_rec: Optional[dict] = None,
    ) -> None:
        """Route one queue message. ``rep_rec`` (fresh enqueues only) is
        the replication record; the replica list is read inside the SAME
        critical section that enters the message into pending/inflight, so
        a standby's snapshot cut can never fall between them (a message
        missing from both snapshot and stream would be silently lost on
        failover despite the publisher's fsynced ack)."""
        while True:
            reps: list = []
            with self._lock:
                # TTL check first (see _enq_ts comment in __init__): an
                # expired message must neither enter pending/inflight nor be
                # streamed to standbys as live — it takes the dead-letter
                # path below. The replica list read and the pending/inflight
                # entry stay inside this ONE critical section so a standby's
                # snapshot cut can never fall between them.
                ts = self._enq_ts.setdefault(mid, time.time())
                expired = (
                    self.queue_ttl_s > 0
                    and time.time() - ts > self.queue_ttl_s
                )
                if expired:
                    self._enq_ts.pop(mid, None)
                else:
                    if rep_rec is not None:
                        reps = [c for c in self._conns.values() if c.is_replica]
                    targets = [
                        (c, sid)
                        for c in self._conns.values()
                        if c.alive
                        for sid, (kind, pat) in c.subs.items()
                        if kind == "queue" and topic_matches(pat, topic)
                    ]
                    if not targets:
                        self._pending_q.append(
                            (topic, data_hex, deliveries, mid))
                        self._pending_mids.add(mid)
                        c = None
                    else:
                        c, sid = targets[next(self._rr) % len(targets)]
                        did = next(self._did)
                        self._inflight[did] = (
                            topic, data_hex, deliveries + 1, c.cid, mid
                        )
            if expired:
                log.warn("queue message expired (no consumer within TTL)",
                         topic=topic, mid=mid, ttl_s=self.queue_ttl_s)
                self._journal_write({"j": "done", "mid": mid})
                self._replicate({"j": "done", "mid": mid})
                self._dead_letter(topic, data_hex, deliveries)
                return
            for r in reps:
                r.send({"op": "rep", **rep_rec})
            if c is None:
                return
            if c.send(
                {"op": "qmsg", "sid": sid, "did": did,
                 "data": data_hex, "topic": topic}
            ):
                return
            # Dead target: send() marked the conn not-alive, so the next
            # pass excludes it — the retry is bounded by the number of
            # live-at-selection conns. (This used to recurse, which blew
            # the stack during broker-failover churn when a batch of
            # messages all re-routed off the same dying connection.)
            with self._lock:
                self._inflight.pop(did, None)
            rep_rec = None

    def _flush_pending(self) -> None:
        with self._lock:
            pending, self._pending_q = list(self._pending_q), deque()
            self._pending_mids.clear()
        for topic, data_hex, deliveries, mid in pending:
            self._queue_dispatch(topic, data_hex, deliveries, mid)

    def _ttl_sweep_loop(self) -> None:
        """Expire the pending backlog even on a quiet broker: without a
        sweep, TTL would only be evaluated when a new subscription
        triggers a dispatch attempt, so an orphaned result on an idle
        broker would still pend forever."""
        interval = max(1.0, min(self.queue_ttl_s / 4, 60.0))
        while not self._closed:
            time.sleep(interval)
            if self._closed:
                return
            now = time.time()
            expired = []
            with self._lock:
                keep: deque = deque()
                for e in self._pending_q:
                    ts = self._enq_ts.setdefault(e[3], now)
                    if now - ts > self.queue_ttl_s:
                        expired.append(e)
                        self._pending_mids.discard(e[3])
                        self._enq_ts.pop(e[3], None)
                    else:
                        keep.append(e)
                self._pending_q = keep
            for topic, data_hex, deliveries, mid in expired:
                log.warn(
                    "queue message expired (no consumer within TTL)",
                    topic=topic, mid=mid, ttl_s=self.queue_ttl_s,
                )
                self._journal_write({"j": "done", "mid": mid})
                self._replicate({"j": "done", "mid": mid})
                self._dead_letter(topic, data_hex, deliveries)

    def _dead_letter(self, topic: str, data_hex: str, deliveries: int) -> None:
        with self._lock:
            targets = [c for c in self._conns.values() if c.wants_dead_letters]
        for c in targets:
            c.send({"op": "dead", "topic": topic, "data": data_hex,
                    "deliveries": deliveries})


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class _ClientSub(Subscription):
    def __init__(self, client: "TcpClient", sid: int):
        self.client = client
        self.sid = sid

    def unsubscribe(self) -> None:
        self.client._unsubscribe(self.sid)


class TcpClient:
    """One broker connection per process; thread-pool handler execution.

    High availability: ``addrs`` lists broker endpoints in preference
    order (primary first, standbys after — the NATS client's server-list
    semantics). The initial connect walks the list until one accepts; a
    lost connection triggers transparent failover in the reader thread —
    reconnect (cycling the list with backoff up to
    ``reconnect_deadline_s``), re-authenticate, re-establish the AEAD
    channel with fresh ephemerals, and replay every live subscription.
    In-flight direct sends fail fast on disconnect so their app-level
    retry budgets (point2point semantics) spend the wait productively.
    """

    def __init__(
        self,
        host: str,
        port: int,
        workers: int = 16,
        auth_token: Optional[str] = None,
        encrypt: bool = False,
        addrs: Optional[List[Tuple[str, int]]] = None,
        reconnect: bool = True,
        reconnect_deadline_s: float = 60.0,
    ):
        from concurrent.futures import ThreadPoolExecutor

        if encrypt and auth_token is None:
            raise ValueError("encrypt=True requires auth_token")
        self._addrs: List[Tuple[str, int]] = list(addrs or []) or [(host, port)]
        self._auth_token = auth_token
        self._encrypt = encrypt
        self._reconnect = reconnect
        self._reconnect_deadline_s = reconnect_deadline_s
        self._wlock = threading.Lock()
        self._sid = itertools.count(1)
        self._rid = itertools.count(1)
        # sid -> (kind, pattern, handler); pattern kept for failover replay
        self._handlers: Dict[int, Tuple[str, str, object]] = {}
        self._dack_events: Dict[int, Tuple[threading.Event, List[bool]]] = {}
        # rid -> (event, response box) for synchronous KV requests
        self._kv_events: Dict[int, Tuple[threading.Event, List[dict]]] = {}
        self._dead_handlers: List[DeadLetterHandler] = []
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="tcpbus")
        # queue handlers may block (signing bridge reply wait): own pool so
        # they cannot starve pub/sub + direct delivery
        self._qpool = ThreadPoolExecutor(max_workers=workers,
                                         thread_name_prefix="tcpbus-q")
        self._closed = False
        self._connected = threading.Event()
        # replication hook: a standby BrokerServer following a primary sets
        # this to receive "rep" frames (see BrokerServer._follow_loop)
        self._rep_handler = None
        self.sock, self._cipher = self._establish_any(
            time.monotonic() + 10, initial=True
        )
        self._connected.set()
        self._reader = threading.Thread(
            target=self._read_loop, name="tcpbus-read", daemon=True
        )
        self._reader.start()

    # -- connection establishment -------------------------------------------

    def _establish(self, addr: Tuple[str, int]):
        """Open one broker connection: TCP + optional AEAD handshake +
        auth, all synchronously (no reader thread involved — this runs
        both at construction and from the reader during failover)."""
        sock = socket.create_connection(addr, timeout=10)
        if sock.getsockname() == sock.getpeername():
            # TCP simultaneous-open on loopback: hammering a dead broker's
            # (ephemeral) port can self-connect, which both looks like a
            # broker and SQUATS the port so the real one can't rebind
            sock.close()
            raise TransportError(f"self-connection to {addr}")
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        cipher = None
        try:
            if self._encrypt:
                from .secure import derive_cipher, fresh_keypair, hash_token

                priv, epub = fresh_keypair()
                _send_frame(sock, {"op": "ehello", "epub": epub.hex()})
                hello = json.loads(_recv_line_blocking(sock))
                if hello.get("op") != "ehello":
                    raise TransportError(
                        "broker did not complete AEAD handshake"
                    )
                server_pub = bytes.fromhex(hello["epub"])
                cipher = derive_cipher(
                    priv, server_pub, epub, server_pub,
                    hash_token(self._auth_token), is_server=False,
                )
            if self._auth_token is not None:
                _send_frame(sock, {"op": "auth", "token": self._auth_token},
                            cipher)
                line = _recv_line_blocking(sock)
                if cipher is not None:
                    line = cipher.decrypt(bytes.fromhex(line.decode()))
                if json.loads(line).get("op") != "auth_ok":
                    raise TransportError("broker rejected credentials")
        except BaseException:
            sock.close()
            raise
        return sock, cipher

    def _establish_any(self, deadline: float, initial: bool = False):
        """Walk the address list (with backoff) until a broker accepts.

        The sleep uses AWS-style decorrelated jitter (sleep ~ U(base,
        3·prev), capped): when a broker dies, EVERY client of the bus
        enters this loop at the same instant, and a deterministic
        doubling schedule would hammer the reborn broker in synchronized
        waves — each wave a burst of simultaneous accepts, handshakes
        and auth round-trips. Randomizing per-client spreads the herd.
        """
        import random

        base, cap = 0.1, 2.0
        backoff = base
        last: Exception = TransportError("no broker address configured")
        while True:
            for addr in self._addrs:
                if self._closed:
                    raise TransportError("client closed")
                try:
                    return self._establish(addr)
                except (OSError, TransportError, ValueError,
                        _InvalidTag) as e:
                    last = e
            if time.monotonic() >= deadline or (initial and not
                                                self._reconnect):
                raise TransportError(
                    f"no broker reachable among {self._addrs}: {last!r}"
                )
            time.sleep(backoff)
            backoff = min(cap, random.uniform(base, backoff * 3))

    def close(self) -> None:
        self._closed = True
        self._connected.set()  # release senders parked on the event
        try:
            self.sock.shutdown(socket.SHUT_RDWR)  # wake the reader's recv
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._qpool.shutdown(wait=False, cancel_futures=True)

    def _send(self, obj: dict) -> None:
        # two attempts: a send can lose the connection-lost race with the
        # reader (event still set, socket just died) — park through the
        # failover once and retry before surfacing an error
        for attempt in (0, 1):
            if self._closed:
                raise TransportError("client closed")
            # park briefly through a failover window instead of erroring
            if not self._connected.wait(timeout=10) or self._closed:
                raise TransportError("broker unreachable")
            with self._wlock:
                try:
                    _send_frame(self.sock, obj, self._cipher)
                    return
                except OSError as e:
                    err = e
            if attempt == 0:
                time.sleep(0.05)  # let the reader notice and clear the event
        raise TransportError(f"broker connection lost: {err!r}")

    # -- subscription registry ----------------------------------------------

    def _subscribe(self, kind: str, pattern: str, handler) -> _ClientSub:
        sid = next(self._sid)
        self._handlers[sid] = (kind, pattern, handler)
        self._send({"op": "sub", "kind": kind, "pattern": pattern, "sid": sid})
        return _ClientSub(self, sid)

    def _unsubscribe(self, sid: int) -> None:
        self._handlers.pop(sid, None)
        try:
            self._send({"op": "unsub", "sid": sid})
        except TransportError:
            pass

    # -- reader --------------------------------------------------------------

    def _read_loop(self) -> None:
        while not self._closed:
            buf = b""
            try:
                while not self._closed:
                    chunk = self.sock.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        if line:
                            if self._cipher is not None:
                                line = self._cipher.decrypt(
                                    bytes.fromhex(line.decode())
                                )
                            self._dispatch(json.loads(line))
            except (OSError, ValueError, _InvalidTag):
                pass  # a tampered/desynced AEAD stream is a dead connection
            if self._closed or not self._reconnect:
                return
            self._connected.clear()  # before touching the socket: senders
            # must park on the event, not race into a closing fd
            # close the dead socket NOW: an abandoned half-open fd leaves
            # the broker side in FIN_WAIT_2, which (unlike TIME_WAIT)
            # blocks a restarted broker from rebinding its port
            try:
                self.sock.close()
            except OSError:
                pass
            # the reader alone runs the failover: it must survive any
            # surprise (e.g. a racing subscribe during replay) or the
            # client is bricked with the broker healthy
            while not self._closed and not self._connected.is_set():
                try:
                    self._failover()
                except Exception as e:  # noqa: BLE001
                    log.error("tcp bus: failover error; retrying",
                              error=repr(e))
                    time.sleep(0.5)

    def _failover(self) -> None:
        """Reconnect (possibly to a standby) and replay subscriptions."""
        self._connected.clear()
        # outstanding direct sends cannot be acked on a dead connection:
        # fail them now so their retry budgets cover the reconnect window
        for evt, result in list(self._dack_events.values()):
            result.append(False)
            evt.set()
        # likewise outstanding KV requests (kv_request retries once after
        # the reconnect)
        for evt, box in list(self._kv_events.values()):
            box.append({"err": "connection lost"})
            evt.set()
        log.warn("tcp bus: broker connection lost; failing over",
                 addrs=str(self._addrs))
        # retry FOREVER (the NATS client model): a broker outage longer
        # than the deadline must degrade to parked/erroring sends, never
        # permanently brick the process — the deadline only paces how
        # often the outage is logged
        while True:
            try:
                sock, cipher = self._establish_any(
                    time.monotonic() + self._reconnect_deadline_s
                )
                break
            except TransportError as e:
                if self._closed:
                    return
                log.error("tcp bus: no broker reachable; still retrying",
                          error=repr(e))
        with self._wlock:
            self.sock, self._cipher = sock, cipher
        # replay the live registry on the new broker. list() snapshots the
        # dict in one C call — a concurrent subscribe/unsubscribe must not
        # blow up the iteration (late additions park in _send on
        # _connected and register themselves after the event sets)
        try:
            for sid, (kind, pattern, _h) in sorted(list(self._handlers.items())):
                with self._wlock:
                    _send_frame(self.sock,
                                {"op": "sub", "kind": kind,
                                 "pattern": pattern, "sid": sid},
                                self._cipher)
            if self._dead_handlers:
                with self._wlock:
                    _send_frame(self.sock, {"op": "dead_sub"}, self._cipher)
        except OSError:
            return  # next read-loop pass will fail over again
        self._connected.set()
        log.info("tcp bus: reconnected", subs=len(self._handlers))

    def _dispatch(self, f: dict) -> None:
        op = f.get("op")
        if op in ("auth_ok", "auth_err"):
            return  # auth is synchronous in _establish; stray frames ignored
        if op == "rep":
            if self._rep_handler is not None:
                self._rep_handler(f)
            return
        if op == "msg":
            ent = self._handlers.get(f["sid"])
            if ent:
                handler = ent[2]
                data = bytes.fromhex(f["data"])
                reply = f.get("reply")
                if reply:
                    data = json.dumps(
                        {"reply": reply, "data": data.hex()}
                    ).encode()
                self._pool.submit(self._safe, handler, data)
        elif op == "dmsg":
            ent = self._handlers.get(f["sid"])

            def run():
                ok = True
                if ent:
                    try:
                        ent[2](bytes.fromhex(f["data"]))
                    except Exception:  # noqa: BLE001
                        ok = False
                try:
                    self._send({"op": "ack", "rid": f["rid"],
                                "to_cid": f["from_cid"], "ok": ok})
                except TransportError:
                    pass

            self._pool.submit(run)
        elif op == "dack":
            ent = self._dack_events.get(f["rid"])
            if ent:
                ent[1].append(bool(f.get("ok")))
                ent[0].set()
        elif op == "kvr":
            ent = self._kv_events.get(f["rid"])
            if ent:
                ent[1].append(f)
                ent[0].set()
        elif op == "qmsg":
            ent = self._handlers.get(f["sid"])

            def runq():
                if ent is None:
                    self._send({"op": "qnak", "did": f["did"]})
                    return
                try:
                    ent[2](bytes.fromhex(f["data"]))
                    self._send({"op": "qack", "did": f["did"]})
                except Permanent:
                    self._send({"op": "qnak", "did": f["did"], "permanent": True})
                except Exception:  # noqa: BLE001
                    self._send({"op": "qnak", "did": f["did"]})

            self._qpool.submit(runq)
        elif op == "dead":
            for h in list(self._dead_handlers):
                self._pool.submit(
                    self._safe_dead, h, f["topic"], bytes.fromhex(f["data"]),
                    f["deliveries"],
                )

    @staticmethod
    def _safe(handler, data) -> None:
        try:
            handler(data)
        except Exception as e:  # noqa: BLE001
            log.error("tcp bus handler error", error=repr(e))

    @staticmethod
    def _safe_dead(handler, topic, data, deliveries) -> None:
        try:
            handler(topic, data, deliveries)
        except Exception as e:  # noqa: BLE001
            log.error("dead-letter handler error", error=repr(e))

    # -- ops ------------------------------------------------------------------

    def publish(self, topic: str, data: bytes, reply: Optional[str] = None) -> None:
        self._send({"op": "pub", "topic": topic, "data": data.hex(),
                    "reply": reply})

    def direct_send(self, topic: str, data: bytes, timeout_s: float = 3.0,
                    attempts: int = 3, retry_delay_s: float = 0.05) -> None:
        """Acked unicast with a TIME budget of ``timeout_s * attempts``
        total. An instant dack-failure (no subscriber registered at the
        broker — the normal state mid-failover while peers re-replay
        their subscriptions at different speeds) must not burn a whole
        attempt: the budget is a deadline, retried on a short delay, the
        same patience contract the loopback fabric implements."""
        deadline = time.monotonic() + timeout_s * max(attempts, 1)
        while True:
            rid = next(self._rid)
            evt: Tuple[threading.Event, List[bool]] = (threading.Event(), [])
            self._dack_events[rid] = evt
            try:
                self._send({"op": "direct", "topic": topic, "data": data.hex(),
                            "rid": rid})
                remaining = deadline - time.monotonic()
                if (evt[0].wait(min(max(remaining, 0.05), timeout_s))
                        and evt[1] and evt[1][0]):
                    return
            except TransportError:
                pass  # reconnect in progress: retry within the budget
            finally:
                self._dack_events.pop(rid, None)
            if time.monotonic() + retry_delay_s >= deadline:
                raise TransportError(f"direct send to {topic!r} not acked")
            time.sleep(retry_delay_s)

    def enqueue(self, topic: str, data: bytes, idempotency_key: str = "") -> None:
        self._send({"op": "enqueue", "topic": topic, "data": data.hex(),
                    "key": idempotency_key})

    def kv_request(self, frame: dict, timeout_s: float = 10.0) -> dict:
        """Synchronous control-plane KV round-trip (kvput/kvget/kvdel/
        kvkeys → kvr). One transparent retry after a broker failover —
        KV ops are idempotent, and the standby carries the replicated
        durable keys."""
        last: Exception = TransportError("kv request not attempted")
        for _ in range(2):
            rid = next(self._rid)
            evt, box = threading.Event(), []
            self._kv_events[rid] = (evt, box)
            try:
                self._send({**frame, "rid": rid})
                if not evt.wait(timeout_s):
                    raise TransportError(
                        f"KV request timed out: {frame.get('op')}"
                    )
                if box and "err" not in box[0]:
                    return box[0]
                last = TransportError(
                    f"KV request failed: {box[0].get('err') if box else '?'}"
                )
            except TransportError as e:
                last = e
            finally:
                self._kv_events.pop(rid, None)
            # wait out the failover window before the single retry
            self._connected.wait(timeout=timeout_s)
        raise last

    def add_dead_letter_handler(self, handler: DeadLetterHandler) -> None:
        if not self._dead_handlers:
            self._send({"op": "dead_sub"})
        self._dead_handlers.append(handler)


def parse_addrs(spec: str) -> List[Tuple[str, int]]:
    """``"host:port[,host:port...]"`` → address list (config
    broker_standbys / --follow)."""
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not port.isdigit():
            raise ValueError(
                f"broker address {part!r} must be host:port "
                f"(broker_standbys / --follow)"
            )
        out.append((host or "127.0.0.1", int(port)))
    return out


def tcp_transport(
    host: str,
    port: int,
    auth_token: Optional[str] = None,
    encrypt: bool = False,
    standbys: Optional[List[Tuple[str, int]]] = None,
    workers: int = 16,
) -> Transport:
    """Connect to a broker → a :class:`Transport` bundle. ``standbys``
    appends failover endpoints after the primary (client walks the list).
    ``workers`` bounds each of the client's two handler pools (threads
    start only when a handler finds none idle): a batched node holds one
    queue thread per signing request until its batch answers, so it asks
    for more than the JAX package's fixed 16."""
    client = TcpClient(
        host, port, workers=workers, auth_token=auth_token, encrypt=encrypt,
        addrs=[(host, port)] + list(standbys or []),
    )

    class _PS(PubSub):
        def publish(self, topic, data):
            client.publish(topic, data)

        def publish_with_reply(self, topic, reply_topic, data):
            client.publish(topic, data, reply=reply_topic)

        def subscribe(self, topic, handler: Handler):
            return client._subscribe("pubsub", topic, handler)

    class _DM(DirectMessaging):
        def send(self, topic, data, timeout_s=None):
            if timeout_s is None:
                client.direct_send(topic, data)
            else:
                client.direct_send(
                    topic, data, timeout_s=timeout_s, attempts=1
                )

        def listen(self, topic, handler: Handler):
            return client._subscribe("direct", topic, handler)

    class _MQ(MessageQueue):
        def enqueue(self, topic, data, idempotency_key=""):
            client.enqueue(topic, data, idempotency_key)

        def dequeue(self, topic_filter, handler: QueueHandler):
            return client._subscribe("queue", topic_filter, handler)

    t = Transport(
        pubsub=_PS(),
        direct=_DM(),
        queues=_MQ(),
        set_dead_letter_handler=client.add_dead_letter_handler,
    )
    t.client = client  # keep a handle for close()
    return t
