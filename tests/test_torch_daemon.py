"""The port's node daemon (``node/daemon.py``), its CLIs (``cli/``) and the
networked deployment on the CPU:

- ``run_node(block=False, device="cpu")`` over a port broker with the
  broker control plane: the node registers, its health beat carries the
  ``compile`` section and the flight recorder's ``trace.dropped_spans``,
  and it closes with no client thread left; ``run_node`` without a device
  raises where there is no GPU; with ``warm_enabled`` the warm-start pass
  runs between ``warming`` and ``ready`` and writes its report, with no
  thread left behind; a ``chaos_fault_plan`` JSON (or a ``fault_plan``
  object) wraps the daemon's transport in ``FaultyTransport``;
- ``publish_health`` / ``health_loop`` (as ``tests/test_daemon_health.py``
  checks the JAX package's) and ``load_peers``;
- the CLIs' parsers, and ops-CLI files (peers, registries, identities,
  the initiator key) written by one package and loaded by the other;
- a broker and three daemons as processes of their own
  (``cli.deployment.Deployment``, ``--device cpu``) create two wallets and
  sign with them on ed25519 through ``RemoteCluster``; the same over
  the per-session path on both curves, with a reshare, is slow-marked as
  ``tests/test_e2e_daemon.py`` is.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import pytest
import torch

from mpcium_tpu.cli import ops as jax_ops
from mpcium_tpu.identity import identity as jid
from mpcium_tpu.store import broker_kv as jbkv
from mpcium_tpu.store import kvstore as jkv
from torch_tcp import tcp_threads_down, wait_for  # noqa: F401  (closes every client)

from mpcium_tpu_torch import trace, wire
from mpcium_tpu_torch.cli import main as pmain
from mpcium_tpu_torch.cli.deployment import Deployment
from mpcium_tpu_torch.cli import ops as pops
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.identity import identity as pid
from mpcium_tpu_torch.node.daemon import health_loop, load_peers, publish_health, run_node
from mpcium_tpu_torch.perf import compile_watch
from mpcium_tpu_torch.store.broker_kv import BrokerKV
from mpcium_tpu_torch.store.kvstore import FileKV, MemoryKV
from mpcium_tpu_torch.transport.tcp import BrokerServer, tcp_transport
from mpcium_tpu_torch.utils.metrics import MetricsRegistry

ROOT = Path(__file__).resolve().parents[1]
POOL = ROOT / "mpcium_tpu_torch" / "data" / "safeprimes_1024.json"


# ---------------------------------------------------------------------------
# the health beat
# ---------------------------------------------------------------------------


class _StubConsumer:
    """The slice of EventConsumer the health beat reads."""

    def __init__(self):
        self.metrics = MetricsRegistry()
        self.metrics.counter("scheduler.batches_fired_total").inc(3)
        self.metrics.gauge("scheduler.queue_depth").set(2)

    def health(self):
        compile_watch.export_gauges(self.metrics)
        return {"sessions": 0, "batch_signing": True,
                "compile": compile_watch.health_summary(),
                "metrics": self.metrics.snapshot()}


def test_publish_health_payload_prom_sidecar_and_compile_section():
    compile_watch.reset()
    try:
        kv = MemoryKV()
        consumer = _StubConsumer()
        compile_watch.mark_warming()
        compile_watch.finish(compile_watch.begin("mulmod", "digest1"), "hit")
        snap = publish_health(consumer, kv, "node0")
        assert "ts" in snap and snap["batch_signing"] is True
        stored = json.loads(kv.get("health/node0"))
        assert stored["ts"] == snap["ts"]
        assert stored["metrics"]["counters"]["scheduler.batches_fired_total"] == 3.0
        assert stored["compile"]["state"] == "warming"
        assert stored["compile"]["compiles"] == stored["compile"]["cache_hits"] == 1
        assert stored["compile"]["last"]["engine"] == "mulmod"
        gauges = stored["metrics"]["gauges"]
        assert gauges["compile.ready"] == 0.0 and gauges["k0.plain_calls"] >= 0.0
        assert {"k0.mulmod_launches", "k0.powmod_launches"} <= set(gauges)
        compile_watch.mark_ready()
        publish_health(consumer, kv, "node0")
        prom = kv.get("health/node0.prom").decode()
        assert "# TYPE scheduler_batches_fired_total counter" in prom
        assert 'scheduler_batches_fired_total{node="node0"} 3.0' in prom
        assert 'compile_ready{node="node0"} 1.0' in prom
    finally:
        compile_watch.reset()


def test_health_loop_republishes_and_survives_a_failing_put():
    consumer = _StubConsumer()
    calls = []

    class _FlakyKV(MemoryKV):
        def put(self, key, value):
            calls.append(key)
            if len(calls) % 3 == 0:
                raise OSError("control plane down")
            return super().put(key, value)

    stop = threading.Event()
    t = threading.Thread(target=health_loop, args=(consumer, _FlakyKV(), "node0", stop, 0.05),
                         daemon=True)
    t.start()
    assert wait_for(lambda: calls.count("health/node0") >= 4, 5.0)
    stop.set()
    t.join(2.0)
    assert not t.is_alive()


def test_load_peers_from_file_then_control_plane(tmp_path):
    cfg = type("Cfg", (), {"peers_file": str(tmp_path / "peers.json"),
                           "control_kv_dir": str(tmp_path / "control"),
                           "control_plane": "file"})()
    kv = MemoryKV()
    with pytest.raises(SystemExit, match="no peers"):
        load_peers(cfg, kv)
    kv.put("mpc_peers/node0", b"u0")
    kv.put("mpc_peers/node1", b"u1")
    assert load_peers(cfg, kv) == {"node0": "u0", "node1": "u1"}
    FileKV(tmp_path / "control").put("mpc_peers/node2", b"u2")
    assert load_peers(cfg) == {"node2": "u2"}
    (tmp_path / "peers.json").write_text(json.dumps({"node9": "u9"}))
    assert load_peers(cfg, kv) == {"node9": "u9"}


# ---------------------------------------------------------------------------
# run_node in-process
# ---------------------------------------------------------------------------


def _workspace(tmp_path, port: int, extra: str = "") -> Path:
    """peers.json of two nodes, their identities, an initiator and a
    config.yaml on the broker control plane."""
    ws = tmp_path / "ws"
    ws.mkdir()
    peers = {"node0": "u0", "node1": "u1"}
    (ws / "peers.json").write_text(json.dumps(peers))
    for nid in peers:
        pid.generate_identity(nid, ws / "identity")
    key = pid.InitiatorKey.generate()
    key.save(ws / "event_initiator.key")
    pool = ws / "pool.json"
    pool.write_bytes(POOL.read_bytes())
    (ws / "config.yaml").write_text(
        f'event_initiator_pubkey: "{key.public_bytes.hex()}"\n'
        f"badger_password: daemon-test-password\n"
        f"broker_port: {port}\ncontrol_plane: broker\n"
        f"identity_dir: {ws / 'identity'}\ndb_dir: {ws / 'db'}\n"
        f"peers_file: {ws / 'peers.json'}\nsafe_prime_pool: {pool}\n"
        f"batch_signing: true\nbatch_max_batch: 8\n" + extra)
    return ws


def test_run_node_over_a_port_broker(tmp_path, monkeypatch):
    from mpcium_tpu_torch.node import daemon

    beats = []  # the health thread's arguments; the test publishes itself
    monkeypatch.setattr(daemon, "health_loop", lambda *a, **kw: beats.append(a))
    broker = BrokerServer(port=0)
    ws = _workspace(tmp_path, broker.port)
    probe = tcp_transport(broker.host, broker.port)
    started = None
    try:
        started = run_node("node0", config_path=str(ws / "config.yaml"), block=False,
                           device="cpu")
        node, consumer, signing, registry = started
        assert node.device == torch.device("cpu") and consumer.scheduler.device == node.device
        assert signing.reply_timeout_s == 30.0  # the default: the JAX value
        assert node.transport.client._qpool._max_workers == 16 + 2 * 8
        kv = BrokerKV(probe.client)
        assert wait_for(lambda: "ready/node0" in kv.keys("ready/"), 10.0)
        assert wait_for(lambda: beats) and beats[0][0] is consumer and beats[0][2] == "node0"
        snap = publish_health(consumer, kv, "node0")
        assert snap["compile"]["state"] == "ready" and snap["compile"]["compiles"] == 0
        assert snap["compile"]["ledger"] == str(ws / "db" / "node0" / "COMPILE_LEDGER.json")
        gauges = json.loads(kv.get("health/node0"))["metrics"]["gauges"]
        assert gauges["trace.dropped_spans"] == 0.0 and gauges["compile.ready"] == 1.0
        assert gauges["k0.mulmod_launches"] == 0.0
        assert trace.armed()
    finally:
        if started is not None:
            node, consumer, signing, registry = started
            signing.close()
            consumer.close()
            registry.resign()
            node.transport.client.close()
        trace.disarm()
        compile_watch.reset()
        probe.client.close()
        broker.close()


def _boot_warm(tmp_path, monkeypatch, extra: str):
    """run_node(block=False, device="cpu") over a port broker with the warm
    config ``extra``: → (the warm report, the compile state seen at the
    start and at the end of the warm pass, the state after boot). Closes
    the node and the broker and checks that no non-daemon thread is left
    behind."""
    from mpcium_tpu_torch.node import daemon
    from mpcium_tpu_torch.warm import manifest as wm
    from mpcium_tpu_torch.warm import prewarm as pw

    monkeypatch.setattr(daemon, "health_loop", lambda *a, **kw: None)
    monkeypatch.setattr(pw, "_RAN", set())  # no bucket run by an earlier test counts
    states = []
    warm = pw.prewarm_for_daemon

    def spy(cfg, name, device):
        states.append(compile_watch.health_summary()["state"])
        report = warm(cfg, name, device)
        states.append(compile_watch.health_summary()["state"])
        return report

    monkeypatch.setattr(pw, "prewarm_for_daemon", spy)
    def alive():  # the threads a leak check counts: daemon threads die with the process
        return {t for t in threading.enumerate() if not t.daemon}

    before = alive()
    broker = BrokerServer(port=0)
    ws = _workspace(tmp_path, broker.port, "warm_enabled: true\n" + extra)
    started = None
    try:
        started = run_node("node0", config_path=str(ws / "config.yaml"), block=False,
                           device="cpu")
        ready = compile_watch.health_summary()["state"]
        node_dir = ws / "db" / "node0"
        report = json.loads((Path(pw.default_cache_dir(str(node_dir)))
                             / wm.REPORT_BASENAME).read_text())
    finally:
        if started is not None:
            node, consumer, signing, registry = started
            signing.close()
            consumer.close()
            registry.resign()
            node.transport.client.close()
        trace.disarm()
        compile_watch.reset()
        broker.close()
    assert wait_for(lambda: alive() <= before, 15.0), sorted(t.name for t in alive() - before)
    return report, states, ready


@pytest.mark.parametrize("extra,item", [("warm_enabled: true\n", "item 8")])
def test_run_node_raises_for_the_parts_not_ported(tmp_path, monkeypatch, extra, item):
    """The config that raised while the warm-start pass was not ported
    (ROADMAP queue 1, ``item``) boots now: with no warm budget left every
    entry of the manifest is skipped and the node still goes ready."""
    report, states, ready = _boot_warm(tmp_path, monkeypatch, extra + "warm_budget_s: 0\n")
    assert states == ["warming", "warming"] and ready == "ready", item
    t = report["totals"]
    assert t["entries"] == t["skipped"] > 0 and t["warmed"] == t["failed"] == 0
    assert {r["reason"] for r in report["results"]} == {"budget exhausted"}


def test_run_node_warm_boot(tmp_path, monkeypatch):
    """``warm_enabled: true`` with ``warm_schemes: eddsa`` and
    ``warm_max_b: 2``: the warm pass signs the buckets 1 and 2 of the
    2-of-3 EdDSA engine on the node's device while the compile state
    reads ``warming``, then the node reads ``ready``; the report has JAX's
    keys, failed and skipped 0."""
    report, states, ready = _boot_warm(
        tmp_path, monkeypatch, "warm_schemes: eddsa\nwarm_max_b: 2\nmpc_threshold: 1\n")
    assert states == ["warming", "warming"] and ready == "ready"
    assert sorted(report) == ["budget_s", "comment", "key", "results", "totals"]
    assert report["totals"] == {"entries": 2, "warmed": 2, "already": 0, "skipped": 0,
                                "failed": 0, "hits": 0, "misses": 0, "unpredicted": 0}
    assert [(r["engine"], r["shape"], r["status"], r["device"], r["cache"])
            for r in report["results"]] == [("eddsa.sign", "B1|q2", "warmed", "cpu", "none"),
                                            ("eddsa.sign", "B2|q2", "warmed", "cpu", "none")]


@pytest.mark.parametrize("via", ["config", "argument"])
def test_chaos_fault_plan_wraps_the_daemon_transport(tmp_path, via):
    """A plan JSON named by the ``chaos_fault_plan`` key (or a plan
    object passed as ``fault_plan=``) wraps the daemon's transport in a
    ``FaultyTransport``: its drop rule drops what it matches, in the
    transport's stats, the rest passes, and the broker control plane
    still rides the wrapped bundle's client."""
    from mpcium_tpu_torch.faults import FaultPlan, FaultyTransport, drop

    plan = FaultPlan(5, [drop(p=1.0, topic="probe:*", channel="pubsub")])
    (tmp_path / "plan.json").write_text(json.dumps(plan.to_json()))
    broker = BrokerServer(port=0)
    extra = f"chaos_fault_plan: {tmp_path / 'plan.json'}\n" if via == "config" else ""
    ws = _workspace(tmp_path, broker.port, extra)
    probe = tcp_transport(broker.host, broker.port)
    started = None
    try:
        started = run_node("node0", config_path=str(ws / "config.yaml"), block=False,
                           device="cpu", fault_plan=plan if via == "argument" else None)
        node, consumer, signing, registry = started
        ft = node.transport
        assert isinstance(ft, FaultyTransport) and ft.node_id == "node0"
        assert ft.plan.to_json() == plan.to_json()
        assert wait_for(lambda: "ready/node0" in BrokerKV(probe.client).keys("ready/"), 10)
        got = []
        for topic in ("probe:*", "other:*"):
            probe.pubsub.subscribe(topic, got.append)

        def passes(data: bytes) -> bool:  # once the subscriptions are live
            ft.pubsub.publish("other:1", data)
            return wait_for(lambda: data in got, 0.5)

        assert wait_for(lambda: passes(b"live"), 10.0)
        ft.pubsub.publish("probe:1", b"dropped")
        assert passes(b"after") and b"dropped" not in got
        assert ft.stats.to_json()["counters"] == {"drop#0": {"drop": 1}}
    finally:
        if started is not None:
            node, consumer, signing, registry = started
            signing.close()
            consumer.close()
            registry.resign()
            node.transport.close()
            node.transport.client.close()
        trace.disarm()
        compile_watch.reset()
        probe.client.close()
        broker.close()


def test_run_node_and_start_without_a_device_raise_here(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None means that GPU")
    ws = _workspace(tmp_path, 9)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_node("node0", config_path=str(ws / "config.yaml"), block=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmain.main(["start", "-n", "node0", "--config", str(ws / "config.yaml")])
    assert set(threading.enumerate()) <= before


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_cli_parsers_match_the_jax_ones():
    from mpcium_tpu.cli import main as jmain

    a = pmain.build_parser().parse_args(["start", "-n", "node0"])
    assert (a.command, a.name, a.config, a.device) == ("start", "node0", "config.yaml", "cuda")
    assert pmain.build_parser().parse_args(["start", "-n", "n", "--device", "cpu"]).device == "cpu"
    for argv in (["broker", "--port", "4444", "--journal", "j.jsonl", "--encrypt",
                  "--follow", "h:1"], ["version"]):
        assert vars(pmain.build_parser().parse_args(argv)) == vars(
            jmain.build_parser().parse_args(argv))
    for argv in (["generate-peers", "-n", "3"], ["register-peers", "--broker", "h:1"],
                 ["generate-identity", "--node", "node0", "--encrypt"],
                 ["generate-initiator", "-o", "x"]):
        assert vars(pops.build_parser().parse_args(argv)) == vars(
            jax_ops.build_parser().parse_args(argv))
    assert pmain.build_parser().prog == "mpcium-tpu-torch"
    assert pops.build_parser().prog == "mpcium-tpu-torch-cli"


def test_cli_version(capsys):
    from mpcium_tpu_torch import __version__

    assert pmain.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == __version__


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ops_cli_files_load_in_the_other_package(tmp_path, writer, capsys):
    """Peers, a FileKV registry, identities and the initiator key written
    by one package's ops CLI are read by the other package's stores."""
    from mpcium_tpu import wire as jwire

    if writer == "port":  # read by the JAX package
        wops, rid, rkv, rwire = pops, jid, jkv.FileKV, jwire
    else:
        wops, rid, rkv, rwire = jax_ops, pid, FileKV, wire
    d = tmp_path
    assert wops.main(["generate-peers", "-n", "3", "-o", str(d / "peers.json")]) == 0
    assert wops.main(["register-peers", "-p", str(d / "peers.json"),
                      "--registry-dir", str(d / "control")]) == 0
    for i in range(3):
        assert wops.main(["generate-identity", "--node", f"node{i}", "--identity-dir",
                          str(d / "identity"), "-p", str(d / "peers.json")]) == 0
    assert wops.main(["generate-initiator", "-o", str(d)]) == 0
    capsys.readouterr()
    peers = json.loads((d / "peers.json").read_text())
    assert sorted(peers) == ["node0", "node1", "node2"]
    reg = rkv(d / "control")
    assert {k: reg.get(k).decode() for k in reg.keys("mpc_peers/")} == {
        f"mpc_peers/{n}": u for n, u in peers.items()}
    initiator = rid.InitiatorKey.load(d / "event_initiator.key")
    meta = json.loads((d / "event_initiator.json").read_text())
    assert initiator.public_bytes.hex() == meta["public_key"]
    stores = {n: rid.IdentityStore(d / "identity", n, peers,
                                   initiator_pubkey=initiator.public_bytes) for n in peers}
    raw = b"command bytes"
    assert stores["node1"].verify_initiator(raw, initiator.sign(raw))
    env = rwire.Envelope(session_id="s", round="r1", from_id="node0", payload={"x": 1},
                         to=None, is_broadcast=True)
    stores["node0"].sign_envelope(env)
    assert stores["node2"].verify_envelope(env)
    env.payload["x"] = 2
    assert not stores["node2"].verify_envelope(env)


@pytest.mark.parametrize("cli", ["port", "jax"])
def test_register_peers_into_an_encrypted_port_broker(tmp_path, cli, capsys):
    ops = pops if cli == "port" else jax_ops
    (tmp_path / "peers.json").write_text(json.dumps({"node0": "u0", "node1": "u1"}))
    broker = BrokerServer(port=0, auth_token="tok", encrypt=True)
    t = None
    try:
        assert ops.main(["register-peers", "-p", str(tmp_path / "peers.json"),
                         "--broker", f"127.0.0.1:{broker.port}", "--broker-token", "tok",
                         "--broker-encrypt"]) == 0
        capsys.readouterr()
        t = tcp_transport(broker.host, broker.port, auth_token="tok", encrypt=True)
        want = {"mpc_peers/node0": b"u0", "mpc_peers/node1": b"u1"}
        assert BrokerKV(t.client).scan("mpc_peers/") == want
        assert jbkv.BrokerKV(t.client).scan("mpc_peers/") == want
    finally:
        if t is not None:
            t.client.close()
        broker.close()


# ---------------------------------------------------------------------------
# a broker and three daemons as processes
# ---------------------------------------------------------------------------

def _burst(subscribe, fire, key, n, t_limit=300.0):
    got, done = {}, threading.Event()

    def on(ev):
        got[key(ev)] = ev
        if len(got) >= n:
            done.set()

    sub = subscribe(on)
    try:
        fire()
        assert done.wait(t_limit), f"{len(got)}/{n} results"
    finally:
        sub.unsubscribe()
    return got


@pytest.fixture
def one_thread(monkeypatch):
    """The daemons' torch on one thread: tiny float64 products only
    contend (the processes inherit the environment)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_daemon_processes_create_and_sign_eddsa(tmp_path, one_thread):
    """Broker + three ``mpcium_tpu_torch.cli.main start --device cpu``
    processes, bootstrapped by the port's ops CLI, batch two wallets'
    creation and their ed25519 signs; every node exits 0 on SIGTERM."""
    dep = Deployment(tmp_path / "dep", dev="cpu",
                        cfg={"batch_window_s": 2.0, "batch_manifest_timeout_s": 300.0,
                             "batch_deadline_ms": 900_000, "reply_timeout_s": 300.0})
    rc = None
    try:
        dep.start()
        rc = dep.remote()
        wallets = ["d0", "d1"]
        kg = _burst(rc.client.on_wallet_creation_result,
                    lambda: [rc.client.create_wallet(w) for w in wallets],
                    lambda ev: ev.wallet_id, 2)
        assert all(ev.result_type == wire.RESULT_SUCCESS for ev in kg.values()), kg
        # the first node's result can precede a peer's stored share: sign
        # once every node's health beat shows no session and no claim
        kv = BrokerKV(rc.transport.client)
        h = dep.health(kv, time.time())
        assert all(s["batches_run"] == 1 and s["compile"]["state"] == "ready"
                   for s in h.values()), h
        msgs = {w: f"transfer {w}".encode() * 2 for w in wallets}
        sig = _burst(rc.client.on_sign_result,
                     lambda: [rc.client.sign_transaction(wire.SignTxMessage(
                         "ed25519", w, "sol", f"tx-{w}", msgs[w])) for w in wallets],
                     lambda ev: ev.tx_id, 2)
        for w in wallets:
            ev = sig[f"tx-{w}"]
            assert ev.result_type == wire.RESULT_SUCCESS, ev.error_reason
            assert hm.ed25519_verify(bytes.fromhex(kg[w].eddsa_pub_key), msgs[w],
                                     bytes.fromhex(ev.signature))
        assert sorted(kv.keys("mpc_peers/")) == [f"mpc_peers/node{i}" for i in range(3)]
    finally:
        if rc is not None:
            rc.close()
        stopped = dep.stop()
    assert all(code == 0 for code, _ in stopped.values()), stopped
    doc = json.loads((dep.root / "node0" / "db" / "node0" / "trace_shutdown.json").read_text())
    assert trace.validate_chrome(doc) > 0
    assert any(e["name"].startswith("round:") for e in doc["traceEvents"])


@pytest.mark.slow
def test_daemon_processes_per_session_create_sign_reshare_sign(tmp_path, one_thread):
    """The whole lifecycle over processes on the per-session path (as
    ``tests/test_e2e_daemon.py`` runs the JAX daemons): one wallet
    created on both curves, signed on both, rotated on both (t=1, epoch 1)
    and signed again."""
    dep = Deployment(tmp_path / "dep", dev="cpu",
                        cfg={"batch_signing": False, "reply_timeout_s": 300.0})
    rc = None
    try:
        dep.start()
        rc = dep.remote()
        ev = rc.create_wallet_sync("w-e2e", timeout_s=900)
        keys = {"secp256k1": bytes.fromhex(ev.ecdsa_pub_key),
                "ed25519": bytes.fromhex(ev.eddsa_pub_key)}

        def sign(tag):
            digest = bytes(range(32))
            for kt, pub in keys.items():
                res = rc.sign_sync(wire.SignTxMessage(kt, "w-e2e", "net", f"{tag}-{kt}",
                                                      digest), timeout_s=900)
                assert res.result_type == wire.RESULT_SUCCESS, res.error_reason
                if kt == "ed25519":
                    assert hm.ed25519_verify(pub, digest, bytes.fromhex(res.signature))
                else:
                    assert hm.ecdsa_verify(hm.secp_decompress(pub), int.from_bytes(digest, "big"),
                                           int(res.r, 16), int(res.s, 16))

        sign("t1")
        for kt, pub in keys.items():
            rs = rc.reshare_sync("w-e2e", 1, kt, timeout_s=900)
            assert bytes.fromhex(rs.pub_key) == pub
        sign("t2")
    finally:
        if rc is not None:
            rc.close()
        stopped = dep.stop()
    assert all(code == 0 for code, _ in stopped.values()), stopped
