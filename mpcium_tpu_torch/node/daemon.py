"""Node daemon: the `mpcium start -n node0` equivalent (cmd/mpcium/main.go).

The port's copy of the JAX package's ``node/daemon.py``. It wires every
subsystem by hand like the reference (main.go:86-200): config → logging →
control-plane KV → encrypted share store → keyinfo → identity → TCP bus
transport → registry → node (pre-params) → event consumer + timeout
consumer → ready → signing consumer → the warm-start pass (with
``warm_enabled``) → ready to serve, then blocks until SIGINT/SIGTERM.

``device`` is the node's card: the node, its event consumer and its batch
scheduler build every batched party on it. ``None`` means the GPU and
raises when there is none, before anything connects; the session axis of
the batched EdDSA dispatches is then split over every local GPU
(``engine/sharded.arm_session_axis``; one GPU arms nothing), as the JAX
daemon splits it over every local chip. An explicit device is used
alone: ``device="cpu"`` runs the plain versions. The warm-start pass
(``warm/prewarm.prewarm_for_daemon``) runs the serving buckets on the
node's device while health reads ``warming``. Where the JAX daemon
differs:

- the signing bridge waits ``reply_timeout_s`` (config; JAX fixes 30 s),
  and a batched node's TCP client sizes its handler pools for a full
  batch on each curve (16 + 2 × ``batch_max_batch`` threads, started on
  demand; JAX fixes 16): a signing request holds a queue thread until its
  batch answers;
- on shutdown the node writes its flight recorder as Chrome trace JSON to
  ``<db_dir>/<name>/trace_shutdown.json``;
- arming the session axis is not wrapped in a warning: it builds no XLA
  mesh, so a failure there is a fault and stops the boot;
- a daemon with a fault plan closes its faulty transport's timers on
  shutdown.
"""
from __future__ import annotations

import getpass
import json
import signal
import threading
import time
from pathlib import Path

import torch

from ..config import check_required, init_config
from ..consumers.event_consumer import EventConsumer
from ..consumers.signing_consumer import SigningConsumer, TimeoutConsumer
from ..device import DeviceLike, resolve
from ..identity.identity import IdentityStore
from ..registry.registry import PeerRegistry
from ..store.keyinfo import KeyinfoStore
from ..store.kvstore import EncryptedFileKV, FileKV
from ..trace import arm as trace_arm
from ..trace import snapshot_chrome
from ..transport.tcp import tcp_transport
from ..utils import log
from .node import Node

TRACE_DUMP = "trace_shutdown.json"


def publish_health(consumer, control_kv, name: str) -> dict:
    """One health beat: publish the consumer's operational snapshot as
    JSON under ``health/<name>`` and the same registry as Prometheus text
    exposition under ``health/<name>.prom`` — so ``kv get health/node0``
    stays the whole monitoring story and a scrape sidecar can serve
    ``.prom`` verbatim. Returns the JSON snapshot (tests assert on it)."""
    snap = consumer.health()
    snap["ts"] = time.time()
    control_kv.put(
        f"health/{name}",
        json.dumps(snap, sort_keys=True).encode(),
    )
    control_kv.put(
        f"health/{name}.prom",
        consumer.metrics.to_prometheus(labels={"node": name}).encode(),
    )
    return snap


def health_loop(consumer, control_kv, name: str, stop: threading.Event,
                interval_s: float = 10.0) -> None:
    """Periodic health publisher (daemon thread body). A failed publish
    is logged and the beat continues — monitoring must never kill the
    node it monitors."""
    while not stop.wait(interval_s):
        try:
            publish_health(consumer, control_kv, name)
        except Exception as e:  # noqa: BLE001 — never kill the beat
            log.warn("health publish failed", node=name, error=repr(e))


def load_peers(cfg, kv=None) -> dict:
    """peers.json {name: uuid} (reference generate-peers.go), else the
    control-plane ``mpc_peers/`` prefix (reference LoadPeersFromConsul,
    main.go:302-311) — from ``kv`` when given (broker control plane),
    else the FileKV directory."""
    p = Path(cfg.peers_file)
    if p.exists():
        return json.loads(p.read_text())
    kv = kv if kv is not None else FileKV(cfg.control_kv_dir)
    peers = {}
    for key in kv.keys("mpc_peers/"):
        peers[key[len("mpc_peers/"):]] = (kv.get(key) or b"").decode()
    if not peers:
        raise SystemExit(
            f"no peers: neither {cfg.peers_file} nor mpc_peers/ in the "
            f"{cfg.control_plane!r} control plane (run mpcium-tpu-torch-cli "
            f"generate-peers + register-peers first)"
        )
    return peers


def _workers(cfg) -> int:
    """Handler threads per pool of the node's TCP client: a batched node
    holds one queue thread per signing request until its batch answers."""
    return 16 + (2 * cfg.batch_max_batch if cfg.batch_signing else 0)


def run_node(
    name: str,
    config_path: str = "config.yaml",
    decrypt_private_key: bool = False,
    debug: bool = False,
    block: bool = True,
    fault_plan=None,
    device: DeviceLike = None,
):
    # resolve first: a node without its card raises before it connects
    dev = resolve(device)
    cfg = init_config(config_path)
    log.init(
        production=cfg.environment == "production",
        level="DEBUG" if debug else "INFO",
    )
    check_required(cfg, ["badger_password", "event_initiator_pubkey"])
    # arm the flight recorder for this node: bounded ring buffer, incident
    # dumps (shed / timeout) land under the db dir
    node_dir = Path(cfg.db_dir) / name
    trace_arm(node_ids=[name], dump_dir=str(node_dir / "trace_incidents"))
    # compile ledger: this node is alive but not serving until boot
    # completes; K0's build (at its first launch) lands beside its stores
    from ..perf import compile_watch

    compile_watch.mark_warming()
    compile_watch.set_ledger_dir(str(node_dir))
    passphrase = cfg.passphrase or None
    if decrypt_private_key and passphrase is None:
        passphrase = getpass.getpass(f"passphrase for {name} identity key: ")

    # chaos seam: an explicit plan argument or the chaos_fault_plan
    # config knob (path to a plan JSON) wraps this daemon's transport in
    # a FaultyTransport; the JSON loads before anything connects. Absent
    # both — the normal case — nothing is constructed.
    fault_plan = fault_plan or (cfg.chaos_fault_plan or None)
    if isinstance(fault_plan, (str, Path)):
        from ..faults.plan import FaultPlan

        fault_plan = FaultPlan.from_json(Path(fault_plan).read_text())

    # transport first: with the broker control plane the SAME connection
    # serves registry/keyinfo/peers
    from ..transport.tcp import parse_addrs

    transport = tcp_transport(
        cfg.broker_host, cfg.broker_port,
        auth_token=cfg.broker_token or None,
        encrypt=cfg.broker_encrypt,
        standbys=parse_addrs(cfg.broker_standbys),
        workers=_workers(cfg),
    )
    # chaos seam: the plan (loaded above) wraps this daemon's transport
    if fault_plan is not None:
        from ..faults.transport import FaultyTransport

        transport = FaultyTransport(transport, name, fault_plan)
        # mpclint: disable=MPL101,MPF701 — fault-plan seed is the chaos replay handle and must be logged; not key material
        log.warn("CHAOS: fault plan installed", node=name,
                 seed=fault_plan.seed, rules=fault_plan.describe())
    if cfg.control_plane == "broker":
        from ..store.broker_kv import BrokerKV

        control_kv = BrokerKV(transport.client)
    elif cfg.control_plane == "file":
        control_kv = FileKV(cfg.control_kv_dir)
    else:
        transport.client.close()
        raise SystemExit(
            f"control_plane={cfg.control_plane!r}: expected 'file' or "
            f"'broker'"
        )

    peers = load_peers(cfg, control_kv)
    if name not in peers:
        transport.client.close()
        raise SystemExit(f"node {name!r} not in peer set {sorted(peers)}")

    share_store = EncryptedFileKV(node_dir, cfg.badger_password)
    # crash-recovery WAL (default off): journals live sessions under the
    # share store's AEAD so a SIGKILL'd node resumes mid-round after restart
    session_wal = None
    if cfg.session_wal:
        from ..store.session_wal import SessionWALStore

        session_wal = SessionWALStore(share_store)
    keyinfo = KeyinfoStore(control_kv)
    identity = IdentityStore(
        cfg.identity_dir,
        name,
        peers,
        initiator_pubkey=bytes.fromhex(cfg.event_initiator_pubkey),
        passphrase=passphrase,
    )
    registry = PeerRegistry(name, list(peers), control_kv)
    node = Node(
        node_id=name,
        peer_ids=list(peers),
        transport=transport,
        identity=identity,
        kvstore=share_store,
        keyinfo=keyinfo,
        registry=registry,
        safe_prime_pool=cfg.safe_prime_pool or None,
        session_wal=session_wal,
        device=dev,
    )
    # multi-GPU hosts split the session axis of batched dispatches over
    # every local card (engine/sharded.py; one card arms nothing); an
    # explicit device is used alone
    from ..engine.sharded import arm_session_axis

    mesh = arm_session_axis(None if device is None else [dev])
    if device is None:
        log.info("session axis", node=name, devices=torch.cuda.device_count(),
                 sharded=mesh is not None)
    consumer = EventConsumer(
        node, transport,
        batch_signing=cfg.batch_signing,
        batch_window_s=cfg.batch_window_s,
        device=dev,
    )
    consumer.run()
    TimeoutConsumer(transport).run()
    registry.ready()
    # boot-time crash recovery: replay incomplete WAL sessions AFTER the
    # consumer subscribed (resumed peers' answers must not race our subs)
    # and after ready() so peers treat us as live again
    if session_wal is not None:
        try:
            consumer.resume_incomplete()
        except Exception as e:  # noqa: BLE001 — recovery must never block boot
            log.warn("WAL resume scan failed", node=name, error=repr(e))
    signing = SigningConsumer(transport, reply_timeout_s=cfg.reply_timeout_s)
    signing.run()
    # health surface: periodically publish the consumer's operational
    # snapshot to the control plane under ``health/<name>``
    health_stop = threading.Event()
    threading.Thread(
        target=health_loop, args=(consumer, control_kv, name, health_stop),
        name=f"health-{name}", daemon=True,
    ).start()
    # every subsystem is wired and subscribed: with warm_enabled the warm
    # pass runs the serving buckets on the node's device while health
    # still reads "warming"; ready once covered or out of warm_budget_s
    if cfg.warm_enabled:
        from ..warm.prewarm import prewarm_for_daemon

        prewarm_for_daemon(cfg, name, dev)
    compile_watch.mark_ready()
    log.info("node running", node=name, device=str(dev),
             broker=f"{cfg.broker_host}:{cfg.broker_port}")

    if not block:
        return node, consumer, signing, registry

    stop = threading.Event()

    def _sig(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    stop.wait()
    log.info("shutting down", node=name)
    health_stop.set()
    signing.close()
    consumer.close()
    registry.resign()
    if fault_plan is not None:
        transport.close()
    transport.client.close()
    dump_trace(node_dir / TRACE_DUMP, name)
    return 0


def dump_trace(path: Path, name: str) -> None:
    """Write this process's flight recorders as one Chrome trace document
    (the ``trace_snapshot`` of a daemon). Never raises."""
    try:
        path.write_text(json.dumps(snapshot_chrome(meta={"node": name})))
    except OSError as e:
        log.warn("trace dump failed", node=name, error=repr(e))


def run_broker(
    host: str = "127.0.0.1",
    port: int = 4333,
    block: bool = True,
    journal: str = "",
    token: str = "",
    encrypt: bool = False,
    follow: str = "",
):
    """The `nats-server` analogue: `mpcium-tpu-torch broker`. CLI flags
    win; otherwise config.yaml's broker_journal/broker_token apply.
    ``follow`` ("host:port") starts this broker as a hot standby mirroring
    that primary's queue state until the primary dies."""
    from ..transport.tcp import BrokerServer, parse_addrs

    cfg = init_config()
    broker = BrokerServer(
        host=host, port=port,
        journal_path=journal or cfg.broker_journal or None,
        auth_token=token or cfg.broker_token or None,
        encrypt=encrypt or cfg.broker_encrypt,
        follow=parse_addrs(follow)[0] if follow else None,
    )
    log.init()
    log.info("broker listening", host=broker.host, port=broker.port)
    if not block:
        return broker
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    broker.close()
    return 0
