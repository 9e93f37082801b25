"""The port's TCP bus (``transport/tcp.py``), its AEAD channel
(``transport/secure.py``, softcrypto's X25519 and HKDF) and the broker's
control-plane KV (``store/broker_kv.py``), against the JAX package's.

The cases of ``tests/test_tcp_transport.py`` run over each pairing of the
packages: a port broker with port clients, a port broker with JAX
clients, and a JAX broker with port clients (``combo`` = broker/client).
The frames are the same newline-delimited JSON, so every pairing must
behave alike. A journal written by either package's broker replays in the
other's; the KV frames and the journal records are equal byte for byte;
X25519 and HKDF equal the RFC 7748 / RFC 5869 vectors, OpenSSL (through
``cryptography``) and the JAX package's softcrypto; a channel keyed by one
package's ``derive_cipher`` opens the other's frames.

Every test closes its brokers and clients; the module fixture
``tcp_threads_down`` checks that no client thread is left.
"""
from __future__ import annotations

import hashlib
import json
import random
import socket
import threading
import time

import pytest

from mpcium_tpu.core import softcrypto as jsc
from mpcium_tpu.store import broker_kv as jbkv
from mpcium_tpu.transport import secure as jsecure
from mpcium_tpu.transport import tcp as jtcp
from torch_tcp import tcp_threads_down, wait_for  # noqa: F401  (closes every client)

from mpcium_tpu_torch.core import softcrypto as psc
from mpcium_tpu_torch.store import broker_kv as pbkv
from mpcium_tpu_torch.transport import secure as psecure
from mpcium_tpu_torch.transport import tcp as ptcp
from mpcium_tpu_torch.transport.api import QueueConfig, TransportError

PKG = {"port": (ptcp, pbkv), "jax": (jtcp, jbkv)}
COMBOS = ["port/port", "port/jax", "jax/port"]


class _Bus:
    """One broker of one package and any number of clients of another,
    all closed at the end."""

    def __init__(self, combo: str, **broker_kw):
        b, c = combo.split("/")
        self.btcp = PKG[b][0]
        self.ctcp, self.ckv = PKG[c]
        self.broker = self.btcp.BrokerServer(port=0, **broker_kw)
        self.clients = []

    def transport(self, **kw):
        t = self.ctcp.tcp_transport(self.broker.host, self.broker.port, **kw)
        self.clients.append(t.client)
        return t

    def refused(self, **kw):
        """A client that must fail at connect (no reconnect loop)."""
        self.ctcp.TcpClient(self.broker.host, self.broker.port, reconnect=False, **kw)

    def close(self):
        for c in self.clients:
            c.close()
        self.broker.close()


@pytest.fixture(params=COMBOS)
def bus(request):
    b = _Bus(request.param, queue_config=QueueConfig(max_deliver=3))
    yield b
    b.close()


def test_pubsub_fanout(bus):
    t1, t2 = bus.transport(), bus.transport()
    got = []
    t1.pubsub.subscribe("topic:x", lambda d: got.append(("t1", d)))
    t2.pubsub.subscribe("topic:x", lambda d: got.append(("t2", d)))
    time.sleep(0.05)  # sub registration in flight
    t1.pubsub.publish("topic:x", b"hello")
    assert wait_for(lambda: len(got) == 2)
    assert sorted(got) == [("t1", b"hello"), ("t2", b"hello")]


def test_direct_ack_and_failure(bus):
    t1, t2 = bus.transport(), bus.transport()
    got = []
    t2.direct.listen("direct:n2", lambda d: got.append(d))
    time.sleep(0.05)
    t1.direct.send("direct:n2", b"ping")  # blocks until acked
    assert got == [b"ping"]
    with pytest.raises(Exception, match="not acked"):
        t1.client.direct_send("direct:nobody", b"x", timeout_s=0.05, attempts=2,
                              retry_delay_s=0.01)


def test_queue_semantics(bus):
    t = bus.transport()
    dead = []
    t.set_dead_letter_handler(lambda topic, data, n: dead.append((topic, n)))
    attempts = []

    def failing(d):
        attempts.append(d)
        raise RuntimeError("boom")

    t.queues.dequeue("q.f.*", failing)
    time.sleep(0.05)
    t.queues.enqueue("q.f.1", b"m", idempotency_key="k1")
    t.queues.enqueue("q.f.1", b"m", idempotency_key="k1")  # dedup
    assert wait_for(lambda: len(dead) == 1, timeout=10)
    assert len(attempts) == 3 and dead == [("q.f.1", 3)]
    # durable buffering before a consumer exists
    t.queues.enqueue("q.late.1", b"early")
    got = []
    t.queues.dequeue("q.late.*", lambda d: got.append(d))
    assert wait_for(lambda: got == [b"early"])


def test_reply_wrapper(bus):
    t1, t2 = bus.transport(), bus.transport()
    seen = []
    t2.pubsub.subscribe("cmd", lambda d: seen.append(json.loads(d)))
    time.sleep(0.05)
    t1.pubsub.publish_with_reply("cmd", "inbox.1", b"\x01\x02")
    assert wait_for(lambda: len(seen) == 1)
    assert seen[0]["reply"] == "inbox.1"
    assert bytes.fromhex(seen[0]["data"]) == b"\x01\x02"


@pytest.mark.parametrize("combo", COMBOS)
def test_broker_auth(combo):
    """Token auth: a wrong token is rejected at connect, and a tokenless
    client's frames are dropped."""
    b = _Bus(combo, auth_token="s3cret-token")
    try:
        t_ok = b.transport(auth_token="s3cret-token")
        evt = threading.Event()
        t_ok.pubsub.subscribe("x.y", lambda d: evt.set())
        time.sleep(0.2)
        t_ok.pubsub.publish("x.y", b"hello")
        assert evt.wait(5)
        with pytest.raises(Exception, match="rejected credentials"):
            b.refused(auth_token="wrong")
        t_no = b.transport()
        got2 = []
        t_no.pubsub.subscribe("x.y", got2.append)
        time.sleep(0.2)
        t_ok.pubsub.publish("x.y", b"again")
        time.sleep(0.5)
        assert got2 == [], "an unauthenticated subscribe must not receive"
    finally:
        b.close()


@pytest.mark.parametrize("combo", COMBOS)
def test_encrypted_channel_roundtrip(combo):
    """AEAD channel across the packages: pub/sub, direct and queue traffic
    over encrypt=True, and past the plaintext hello the wire is
    ciphertext."""
    b = _Bus(combo, auth_token="chan-token", encrypt=True)
    try:
        t1 = b.transport(auth_token="chan-token", encrypt=True)
        t2 = b.transport(auth_token="chan-token", encrypt=True)
        got, evt = [], threading.Event()
        t2.pubsub.subscribe("enc.topic", lambda d: (got.append(d), evt.set()))
        t2.direct.listen("enc.direct", got.append)
        qgot = []
        t2.queues.dequeue("enc.q.*", qgot.append)
        time.sleep(0.1)
        t1.pubsub.publish("enc.topic", b"secret-payload")
        assert evt.wait(5)
        t1.direct.send("enc.direct", b"direct-payload")
        t1.queues.enqueue("enc.q.1", b"queued-payload", idempotency_key="q1")
        assert wait_for(lambda: qgot == [b"queued-payload"])
        assert got == [b"secret-payload", b"direct-payload"]
        s = socket.create_connection((b.broker.host, b.broker.port), timeout=5)
        try:
            s.sendall(b'{"op":"ehello","epub":"' + b"00" * 32 + b'"}\n')
            line = b""
            s.settimeout(5)
            while b"\n" not in line:
                line += s.recv(4096)
        finally:
            s.close()
        hello = json.loads(line.split(b"\n", 1)[0])
        assert hello["op"] == "ehello" and len(hello["epub"]) == 64
    finally:
        b.close()


@pytest.mark.parametrize("combo", COMBOS)
def test_encrypted_channel_rejects_wrong_token(combo):
    b = _Bus(combo, auth_token="right-token", encrypt=True)
    try:
        with pytest.raises(Exception, match="no broker reachable"):
            b.refused(auth_token="wrong-token", encrypt=True)
    finally:
        b.close()


@pytest.mark.parametrize("combo", COMBOS)
def test_hashed_token_config(combo):
    """The broker accepts a sha256:<hex> stored token; clients still
    present the plaintext."""
    digest = "sha256:" + hashlib.sha256(b"pw12345").hexdigest()
    b = _Bus(combo, auth_token=digest)
    try:
        got, evt = [], threading.Event()
        t = b.transport(auth_token="pw12345")
        t.pubsub.subscribe("x", lambda d: (got.append(d), evt.set()))
        time.sleep(0.1)
        t.pubsub.publish("x", b"ok")
        assert evt.wait(5) and got == [b"ok"]
    finally:
        b.close()


@pytest.mark.parametrize("combo", COMBOS)
def test_broker_kv_roundtrip_and_transient(combo):
    b = _Bus(combo)
    try:
        kv = b.ckv.BrokerKV(b.transport().client)
        assert kv.get("mpc_peers/node0") is None
        kv.put("mpc_peers/node0", b"uuid-0")
        kv.put("mpc_peers/node1", b"uuid-1")
        kv.put_transient("ready/node0", b"171000")
        assert kv.get("mpc_peers/node0") == b"uuid-0"
        assert kv.keys("mpc_peers/") == ["mpc_peers/node0", "mpc_peers/node1"]
        assert kv.keys("ready/") == ["ready/node0"]
        assert kv.scan("mpc_peers/") == {"mpc_peers/node0": b"uuid-0",
                                         "mpc_peers/node1": b"uuid-1"}
        kv.delete("mpc_peers/node1")
        assert kv.get("mpc_peers/node1") is None
        assert kv.keys("mpc_peers/") == ["mpc_peers/node0"]
        kv.put("keyinfo/w1", bytes(range(256)))  # binary-safe values
        assert kv.get("keyinfo/w1") == bytes(range(256))
    finally:
        b.close()


# ---------------------------------------------------------------------------
# journals: durability, and replay across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_broker_journal_survives_restart(tmp_path, writer, reader):
    """A restarted broker (of either package) redelivers every enqueued
    but unacked message of the other's journal, keeps its durable KV keys,
    and does not redeliver acked messages after the next restart."""
    journal = str(tmp_path / "queue.jsonl")
    wt, wkv = PKG[writer]
    rt, _ = PKG[reader]
    b1 = wt.BrokerServer(port=0, journal_path=journal, journal_fsync=False)
    t1 = wt.tcp_transport(b1.host, b1.port)
    t1.queues.enqueue("mpc.results.a", b"payload-1", idempotency_key="k1")
    t1.queues.enqueue("mpc.results.b", b"payload-2")
    wkv.BrokerKV(t1.client).put("keyinfo/w1", b"meta")
    time.sleep(0.3)  # let the broker journal the enqueues
    t1.client.close()
    b1.close()

    b2 = rt.BrokerServer(port=0, journal_path=journal, journal_fsync=False)
    t2 = ptcp.tcp_transport(b2.host, b2.port)
    try:
        got, evt = [], threading.Event()

        def handler(data):
            got.append(data)
            if len(got) == 2:
                evt.set()

        sub = t2.queues.dequeue("mpc.results.*", handler)
        assert evt.wait(10), f"redelivery after restart failed (got {got})"
        assert sorted(got) == [b"payload-1", b"payload-2"]
        assert pbkv.BrokerKV(t2.client).get("keyinfo/w1") == b"meta"
        time.sleep(0.3)  # the acks reach the journal
        sub.unsubscribe()
    finally:
        t2.client.close()
        b2.close()
    b3 = rt.BrokerServer(port=0, journal_path=journal, journal_fsync=False)
    t3 = ptcp.tcp_transport(b3.host, b3.port)
    try:
        got3 = []
        t3.queues.dequeue("mpc.results.*", got3.append)
        time.sleep(0.8)
        assert got3 == []
    finally:
        t3.client.close()
        b3.close()


def test_broker_kv_journal_durability(tmp_path):
    """Durable keys survive a restart of the port's broker through the
    journal; transient (liveness) keys do not."""
    journal = str(tmp_path / "q.jsonl")
    b1 = ptcp.BrokerServer(port=0, journal_path=journal, journal_fsync=False)
    t1 = ptcp.tcp_transport(b1.host, b1.port)
    kv1 = pbkv.BrokerKV(t1.client)
    kv1.put("keyinfo/w1", b"meta")
    kv1.put("mpc_peers/node0", b"uuid-0")
    kv1.put_transient("ready/node0", b"hb")
    kv1.delete("mpc_peers/node0")
    t1.client.close()
    b1.close()
    b2 = ptcp.BrokerServer(port=0, journal_path=journal, journal_fsync=False)
    t2 = ptcp.tcp_transport(b2.host, b2.port)
    try:
        kv2 = pbkv.BrokerKV(t2.client)
        assert kv2.get("keyinfo/w1") == b"meta"
        assert kv2.get("mpc_peers/node0") is None
        assert kv2.keys("ready/") == []
    finally:
        t2.client.close()
        b2.close()


def _journal_after(tcp, bkv, path) -> list:
    """The same queue and KV operations through one package's broker and
    client → its journal records (enqueue stamps dropped: wall clock)."""
    b = tcp.BrokerServer(port=0, journal_path=str(path), journal_fsync=False)
    t = tcp.tcp_transport(b.host, b.port)
    try:
        kv = bkv.BrokerKV(t.client)
        t.queues.enqueue("mpc.q.a", b"\x00payload", idempotency_key="k1")
        t.queues.enqueue("mpc.q.b", b"two")
        kv.put("keyinfo/w1", bytes(range(16)))
        kv.put_transient("ready/node0", b"hb")
        kv.delete("keyinfo/w1")
        kv.put("mpc_peers/node0", b"uuid-0")
        got = []
        t.queues.dequeue("mpc.q.a", got.append)
        assert wait_for(lambda: got == [b"\x00payload"])
        time.sleep(0.3)  # the ack's "done" record
    finally:
        t.client.close()
        b.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    for r in recs:
        r.pop("ts", None)
    return recs


def test_journal_records_equal_jax(tmp_path):
    port = _journal_after(ptcp, pbkv, tmp_path / "port.jsonl")
    jax = _journal_after(jtcp, jbkv, tmp_path / "jax.jsonl")
    assert port == jax
    assert {r["j"] for r in port} == {"enq", "done", "kvp", "kvd"}


class _FrameRecorder:
    """A stand-in client that records the KV frames it is asked to send."""

    def __init__(self):
        self.frames = []

    def kv_request(self, frame, timeout_s):
        self.frames.append((json.dumps(frame, separators=(",", ":")), timeout_s))
        return {"v": "00", "keys": ["a"], "items": {"a": "01"}}


def test_broker_kv_frames_equal_jax():
    rec_p, rec_j = _FrameRecorder(), _FrameRecorder()
    for kv in (pbkv.BrokerKV(rec_p, timeout_s=3.0), jbkv.BrokerKV(rec_j, timeout_s=3.0)):
        kv.put("keyinfo/w1", b"\x01\xff")
        kv.put_transient("ready/node0", b"hb")
        assert kv.get("keyinfo/w1") == b"\x00"
        kv.delete("keyinfo/w1")
        assert kv.keys("keyinfo/") == ["a"]
        assert kv.scan("keyinfo/") == {"a": b"\x01"}
    assert rec_p.frames == rec_j.frames and len(rec_p.frames) == 6


# ---------------------------------------------------------------------------
# queue TTL and replication (the port's broker)
# ---------------------------------------------------------------------------


def test_queue_ttl_expires_orphaned_results():
    """A result whose requester is gone dead-letters once past
    queue_ttl_s, on the next dispatch attempt; a young one is delivered."""
    b = ptcp.BrokerServer(port=0, queue_ttl_s=0.3)
    t = ptcp.tcp_transport(b.host, b.port)
    try:
        dead = []
        t.set_dead_letter_handler(lambda topic, data, n: dead.append((topic, data)))
        t.queues.enqueue("q.result.tx-orphan", b"late-result")
        assert wait_for(lambda: len(b._pending_q) == 1)
        time.sleep(0.4)
        t.queues.dequeue("q.other.*", lambda d: None)
        assert wait_for(lambda: ("q.result.tx-orphan", b"late-result") in dead)
        assert wait_for(lambda: len(b._pending_q) == 0)
        assert not b._enq_ts
        got = []
        t.queues.enqueue("q.result.tx-live", b"r2")
        t.queues.dequeue("q.result.tx-live", lambda d: got.append(d))
        assert wait_for(lambda: got == [b"r2"])
    finally:
        t.client.close()
        b.close()


def test_queue_ttl_sweep_on_idle_broker():
    """The sweep thread expires orphans with no subscription to trigger a
    pending flush."""
    b = ptcp.BrokerServer(port=0, queue_ttl_s=0.3)
    t = ptcp.tcp_transport(b.host, b.port)
    try:
        dead = []
        t.set_dead_letter_handler(lambda topic, data, n: dead.append((topic, data)))
        time.sleep(0.05)
        t.queues.enqueue("q.result.tx-idle", b"late")
        assert wait_for(lambda: len(b._pending_q) == 1)
        assert wait_for(lambda: ("q.result.tx-idle", b"late") in dead, timeout=3.0)
        assert len(b._pending_q) == 0 and not b._enq_ts
    finally:
        t.client.close()
        b.close()


@pytest.mark.parametrize("primary_pkg", ["port", "jax"])
def test_broker_kv_replicates_to_standby(primary_pkg):
    """Durable KV state reaches a port standby (snapshot + stream) from a
    primary of either package, and is readable after the client fails
    over; transient keys are not streamed."""
    primary = PKG[primary_pkg][0].BrokerServer(port=0)
    t = ptcp.tcp_transport(primary.host, primary.port)
    kv = pbkv.BrokerKV(t.client)
    kv.put("keyinfo/pre", b"in-snapshot")
    standby = ptcp.BrokerServer(port=0, follow=(primary.host, primary.port))
    t2 = None
    try:
        assert wait_for(lambda: standby._rep_synced.is_set())
        assert standby._kv.get("keyinfo/pre") is not None
        kv.put("keyinfo/live", b"streamed")
        kv.put_transient("ready/node0", b"hb")
        assert wait_for(lambda: "keyinfo/live" in standby._kv)
        assert "ready/node0" not in standby._kv
        t2 = ptcp.tcp_transport(primary.host, primary.port,
                                standbys=[(standby.host, standby.port)])
        kv2 = pbkv.BrokerKV(t2.client)
        primary.close()
        t.client.close()
        assert wait_for(lambda: kv2.get("keyinfo/live") == b"streamed", timeout=15.0)
        assert kv2.get("keyinfo/pre") == b"in-snapshot"
    finally:
        t.client.close()
        if t2 is not None:
            t2.client.close()
        primary.close()
        standby.close()


def test_tcp_transport_sizes_the_client_pools():
    b = ptcp.BrokerServer(port=0)
    try:
        t = ptcp.tcp_transport(b.host, b.port, workers=40)
        try:
            assert t.client._pool._max_workers == t.client._qpool._max_workers == 40
        finally:
            t.client.close()
        t = ptcp.tcp_transport(b.host, b.port)
        try:
            assert t.client._qpool._max_workers == 16  # the JAX package's size
        finally:
            t.client.close()
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the channel's primitives: X25519, HKDF, the token and the key schedule
# ---------------------------------------------------------------------------

RFC7748_SCALARMULT = [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]
ALICE = "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"
BOB = "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"
ALICE_PUB = "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
BOB_PUB = "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
SHARED = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
RFC5869 = [  # (ikm, salt, info, length, okm): test cases 1 and 3
    ("0b" * 22, "000102030405060708090a0b0c", "f0f1f2f3f4f5f6f7f8f9", 42,
     "3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf"
     "34007208d5b887185865"),
    ("0b" * 22, "", "", 42,
     "8da4e775a563c18f715f802a063c5a31b8a11f5c5ee1879ec3454e5f3c738d2d"
     "9d201395faa4b61a96c8"),
]


@pytest.mark.parametrize("k,u,want", RFC7748_SCALARMULT)
def test_x25519_rfc7748_scalarmult(k, u, want):
    from cryptography.hazmat.primitives.asymmetric import x25519 as ox

    k, u = bytes.fromhex(k), bytes.fromhex(u)
    assert psc._x25519_scalarmult(k, u).hex() == want
    assert jsc._x25519_scalarmult(k, u).hex() == want
    assert ox.X25519PrivateKey.from_private_bytes(k).exchange(
        ox.X25519PublicKey.from_public_bytes(u)).hex() == want


@pytest.mark.parametrize("mod", [psc, jsc], ids=["port", "jax"])
def test_x25519_rfc7748_diffie_hellman(mod):
    a = mod.X25519PrivateKey.from_private_bytes(bytes.fromhex(ALICE))
    b = mod.X25519PrivateKey.from_private_bytes(bytes.fromhex(BOB))
    assert a.public_key().public_bytes_raw().hex() == ALICE_PUB
    assert b.public_key().public_bytes_raw().hex() == BOB_PUB
    assert a.exchange(b.public_key()).hex() == SHARED
    assert b.exchange(a.public_key()).hex() == SHARED
    with pytest.raises(ValueError):  # a low-order point: the all-zero output
        a.exchange(mod.X25519PublicKey.from_public_bytes(b"\x00" * 32))


def test_x25519_equals_openssl_and_jax_on_random_keys():
    from cryptography.hazmat.primitives.asymmetric import x25519 as ox

    rng = random.Random(7)
    for _ in range(8):
        ka, kb = rng.randbytes(32), rng.randbytes(32)
        p = psc.X25519PrivateKey.from_private_bytes(ka)
        o = ox.X25519PrivateKey.from_private_bytes(ka)
        j = jsc.X25519PrivateKey.from_private_bytes(ka)
        pub = p.public_key().public_bytes_raw()
        assert pub == o.public_key().public_bytes_raw() == j.public_key().public_bytes_raw()
        peer = psc.X25519PrivateKey.from_private_bytes(kb).public_key()
        ss = p.exchange(peer)
        assert ss == o.exchange(ox.X25519PublicKey.from_public_bytes(peer.public_bytes_raw()))
        assert ss == j.exchange(jsc.X25519PublicKey.from_public_bytes(peer.public_bytes_raw()))


@pytest.mark.parametrize("ikm,salt,info,length,okm", RFC5869)
def test_hkdf_rfc5869_and_openssl_and_jax(ikm, salt, info, length, okm):
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF as OHKDF

    args = dict(length=length, salt=bytes.fromhex(salt) or None, info=bytes.fromhex(info))
    ikm = bytes.fromhex(ikm)
    assert psc.HKDF(algorithm=psc.SHA256(), **args).derive(ikm).hex() == okm
    assert jsc.HKDF(algorithm=jsc.SHA256(), **args).derive(ikm).hex() == okm
    assert OHKDF(algorithm=hashes.SHA256(), **args).derive(ikm).hex() == okm


@pytest.mark.parametrize("token", ["s3cret", "sha256:" + "ab" * 32, ""])
def test_token_hashing_equals_jax(token):
    assert psecure.hash_token(token) == jsecure.hash_token(token)
    assert psecure.token_matches(token, psecure.hash_token(token))
    assert psecure.token_matches(token, token)
    assert not psecure.token_matches(token + "x", token)


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_channel_keys_open_across_the_packages(client, server):
    """The same ephemerals and token give the same directional keys in
    both packages: each side's frames open on the other's, counter nonce
    by counter nonce; a wrong token fails authentication."""
    mods = {"port": psecure, "jax": jsecure}
    c_priv = psc.X25519PrivateKey.from_private_bytes(bytes.fromhex(ALICE))
    s_priv = psc.X25519PrivateKey.from_private_bytes(bytes.fromhex(BOB))
    c_pub, s_pub = bytes.fromhex(ALICE_PUB), bytes.fromhex(BOB_PUB)
    c = mods[client].derive_cipher(c_priv, s_pub, c_pub, s_pub, "tok", False)
    s = mods[server].derive_cipher(s_priv, c_pub, c_pub, s_pub, "tok", True)
    for i in range(3):
        assert s.decrypt(c.encrypt(b"frame %d" % i)) == b"frame %d" % i
        assert c.decrypt(s.encrypt(b"reply %d" % i)) == b"reply %d" % i
    mitm = mods[server].derive_cipher(s_priv, c_pub, c_pub, s_pub, "bad", True)
    with pytest.raises(Exception):
        mitm.decrypt(c.encrypt(b"frame"))
    # fresh keypairs interoperate too
    cp, cpub = mods[client].fresh_keypair()
    sp, spub = mods[server].fresh_keypair()
    c = mods[client].derive_cipher(cp, spub, cpub, spub, "tok", False)
    s = mods[server].derive_cipher(sp, cpub, cpub, spub, "tok", True)
    assert s.decrypt(c.encrypt(b"hello")) == b"hello"


def test_direct_send_error_is_a_transport_error():
    b = ptcp.BrokerServer(port=0)
    t = ptcp.tcp_transport(b.host, b.port)
    try:
        with pytest.raises(TransportError):
            t.client.direct_send("direct:nobody", b"x", timeout_s=0.05, attempts=1,
                                 retry_delay_s=0.01)
    finally:
        t.client.close()
        b.close()
