"""Broker high availability in the port: a hot standby that follows the
primary, and clients that fail over to it (the cases of
``tests/test_broker_ha.py``). The primary is killed for real and traffic
resumes, including delivery of a message that only ever reached the
primary before it died. The standby is the port's; the primary is the
port's or the JAX package's (``primary``), so a port standby mirrors
either package's queue state and KV."""
from __future__ import annotations

import threading
import time

import pytest

from mpcium_tpu.transport import tcp as jtcp
from torch_tcp import tcp_threads_down, wait_for  # noqa: F401  (closes every client)

from mpcium_tpu_torch.store.broker_kv import BrokerKV
from mpcium_tpu_torch.transport.tcp import BrokerServer, TcpClient, parse_addrs, tcp_transport

TOKEN = "ha-test-token"
PRIMARY = {"port": BrokerServer, "jax": jtcp.BrokerServer}


def _mk_pair(tmp_path, encrypt=False, primary="port"):
    token = TOKEN if encrypt else None
    p = PRIMARY[primary](
        port=0, journal_path=str(tmp_path / "primary.jsonl"),
        journal_fsync=False, auth_token=token, encrypt=encrypt,
    )
    s = BrokerServer(
        port=0, journal_path=str(tmp_path / "standby.jsonl"),
        journal_fsync=False, auth_token=token, encrypt=encrypt,
        follow=(p.host, p.port),
    )
    assert s._rep_synced.wait(10), "standby never synced to primary"
    return p, s


def _client(primary, standby, encrypt=False, **kw):
    return TcpClient(
        primary.host, primary.port,
        addrs=[(primary.host, primary.port), (standby.host, standby.port)],
        auth_token=TOKEN if encrypt else None, encrypt=encrypt,
        reconnect_deadline_s=15.0, **kw,
    )


@pytest.mark.parametrize("primary", ["port", "jax"])
@pytest.mark.parametrize("encrypt", [False, True])
def test_failover_to_standby(tmp_path, encrypt, primary):
    p, s = _mk_pair(tmp_path, encrypt=encrypt, primary=primary)
    producer = consumer = None
    try:
        producer = _client(p, s, encrypt=encrypt)
        # m1 reaches ONLY the primary (no consumer yet), then the primary dies
        producer.enqueue("jobs.a", b"m1", idempotency_key="m1")
        assert wait_for(lambda: bool(s._pending_q), 10), "enqueue was not replicated"
        p.close()

        got, evt = [], threading.Event()

        def handler(data):
            got.append(data)
            evt.set()

        # a consumer arriving after the primary's death connects to the
        # standby and must receive the replicated backlog
        consumer = _client(p, s, encrypt=encrypt)
        consumer._subscribe("queue", "jobs.*", handler)
        assert evt.wait(15), "replicated message never delivered by standby"
        assert got == [b"m1"]

        # the producer's next enqueue rides the failover; the first write
        # can vanish into the dead socket, so it re-sends under the same
        # idempotency key (the SDK's at-least-once contract)
        evt.clear()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not evt.is_set():
            try:
                producer.enqueue("jobs.a", b"m2", idempotency_key="m2")
            except Exception:  # noqa: BLE001 — failover in progress
                pass
            evt.wait(0.5)
        assert evt.is_set(), "post-failover enqueue never delivered"
        assert got[-1] == b"m2"
    finally:
        for c in (producer, consumer):
            if c is not None:
                c.close()
        p.close()
        s.close()


def test_subscriptions_replay_after_failover(tmp_path):
    """Subscriptions made before the failover keep working on the standby
    (the client replays its registry)."""
    p, s = _mk_pair(tmp_path)
    a, b = _client(p, s), _client(p, s)
    try:
        seen, evt = [], threading.Event()
        a._subscribe("pubsub", "events.*", lambda d: (seen.append(d), evt.set()))
        p.close()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not evt.is_set():
            try:
                b.publish("events.x", b"hello")
            except Exception:  # noqa: BLE001 — failover in progress
                pass
            time.sleep(0.1)
        assert evt.is_set(), "pub/sub subscription did not survive failover"
        assert seen[0] == b"hello"
    finally:
        a.close()
        b.close()
        p.close()
        s.close()


def test_restart_same_broker_reconnects(tmp_path):
    """A client outlives a restart of its only broker on the same endpoint
    (the journal replays, the subscriptions replay)."""
    jp = str(tmp_path / "solo.jsonl")
    broker = BrokerServer(port=0, journal_path=jp, journal_fsync=False)
    host, port = broker.host, broker.port
    cli = TcpClient(host, port, reconnect_deadline_s=15.0)
    broker2 = None
    try:
        got, evt = [], threading.Event()
        cli._subscribe("queue", "work.*", lambda d: (got.append(d), evt.set()))
        cli.enqueue("work.q", b"before-restart", idempotency_key="k1")
        assert evt.wait(10)
        broker.close()
        time.sleep(0.3)
        broker2 = BrokerServer(host=host, port=port, journal_path=jp, journal_fsync=False)
        # the restarted broker may first redeliver m1 (its ack can race the
        # shutdown): wait for the new message, tolerating the redelivery
        cli.enqueue("work.q", b"after-restart", idempotency_key="k2")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and b"after-restart" not in got:
            evt.clear()
            evt.wait(0.5)
        assert b"after-restart" in got, f"no recovery from a broker restart: {got}"
    finally:
        cli.close()
        broker.close()
        if broker2 is not None:
            broker2.close()


@pytest.mark.parametrize("spec,want", [
    ("", []),
    ("10.0.0.2:4334", [("10.0.0.2", 4334)]),
    ("a:1, b:2,", [("a", 1), ("b", 2)]),
    (":9", [("127.0.0.1", 9)]),
])
def test_parse_addrs(spec, want):
    assert parse_addrs(spec) == want == jtcp.parse_addrs(spec)


def test_parse_addrs_rejects_a_portless_address():
    with pytest.raises(ValueError, match="host:port"):
        parse_addrs("broker-standby")


def test_two_standby_chain_failover(tmp_path):
    """primary <- s1 <- s2: records applied on s1 are forwarded to s2, so
    after the primary AND s1 die, clients find the whole durable state
    (queues and control-plane KV) on s2."""
    primary = BrokerServer(port=0)
    s1 = BrokerServer(port=0, follow=(primary.host, primary.port))
    assert wait_for(lambda: s1._rep_synced.is_set(), 8)
    s2 = BrokerServer(port=0, follow=(s1.host, s1.port))
    assert wait_for(lambda: s2._rep_synced.is_set(), 8)
    t = None
    try:
        t = tcp_transport(primary.host, primary.port,
                          standbys=[(s1.host, s1.port), (s2.host, s2.port)])
        kv = BrokerKV(t.client)
        kv.put("threshold_keyinfo/w1", b"meta-1")
        t.queues.enqueue("q.work.a", b"payload-1")
        assert wait_for(lambda: "threshold_keyinfo/w1" in s2._kv, 8)
        assert wait_for(lambda: len(s2._pending_q) == 1, 8)

        primary.close()
        assert wait_for(lambda: kv.get("threshold_keyinfo/w1") == b"meta-1", 15.0)
        kv.put("threshold_keyinfo/w2", b"meta-2")
        assert wait_for(lambda: "threshold_keyinfo/w2" in s2._kv, 8)

        s1.close()
        assert wait_for(lambda: kv.get("threshold_keyinfo/w2") == b"meta-2", 15.0)
        got = []
        t.queues.dequeue("q.work.*", lambda d: got.append(d))
        assert wait_for(lambda: got == [b"payload-1"], 8)
    finally:
        if t is not None:
            t.client.close()
        primary.close()
        s1.close()
        s2.close()
