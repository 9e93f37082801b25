"""In-process development cluster, and the fixture loader.

The port's copy of the JAX package's ``cluster.py``: :class:`LocalCluster`
assembles n nodes over the loopback fabric or a TCP broker (with a
hot-standby broker on request) with real identities, encrypted share
stores, registries, consumers and a client — the docker-compose-equivalent
dev stack as one object for tests, examples and the card's smoke run.
``device`` is the cluster's card: every node, event consumer and batch
scheduler gets it, and every batched party they build computes on it.
``None`` means the GPU and raises when there is none, so a cluster never
moves its batches to the CPU on its own; tests pass ``device="cpu"``.
:class:`RemoteCluster` is the client's handle to a running deployment
(broker + daemons, ``node/daemon.py``).

Where the port differs from the JAX cluster: a batched cluster sizes its
transports' handler pools for a full batch on each curve; ``close()``
also closes every TCP client it made and disarms the flight recorder
(its buffers stay for ``trace_snapshot``), and the faulty transports,
retired ones included.
"""
from __future__ import annotations

import json
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import wire
from .client.client import MPCClient
from .consumers.event_consumer import EventConsumer
from .consumers.signing_consumer import SigningConsumer, TimeoutConsumer
from .core.paillier import PreParams
from .device import DeviceLike, resolve
from .identity.identity import IdentityStore, InitiatorKey, generate_identity
from .node.node import Node
from .registry.registry import PeerRegistry
from .store.keyinfo import KeyinfoStore
from .store.kvstore import EncryptedFileKV, MemoryKV
from .trace import arm as _trace_arm
from .trace import disarm as _trace_disarm
from .trace import snapshot_chrome as _trace_snapshot_chrome
from .transport.loopback import LoopbackFabric
from .utils import log

DATA = Path(__file__).resolve().parent / "data"
# name prefixes of the daemon threads a cluster's nodes start (session
# senders, batch runners, timing wheels, GC loops, registry watchers):
# close() waits a bounded time for them to finish
_WORKER_PREFIXES = ("send-", "bsign-", "bdkg-", "brs-", "batch-wheel-",
                    "session-gc-", "registry-")


class _NotMine(Exception):
    """Result event for a different operation: raising naks it back to
    the work queue (transport/api.py contract) so a concurrent waiter
    can dequeue it, instead of silently ack-and-discarding another
    client's result."""


class SyncOps:
    """Blocking convenience wrappers over an :class:`MPCClient` at
    ``self.client``."""

    @staticmethod
    def _await_result(subscribe, fire, matches, timeout_s, what: str):
        done = threading.Event()
        box: list = []

        def on_ev(ev):
            if not matches(ev):
                raise _NotMine(what)
            box.append(ev)
            done.set()

        sub = subscribe(on_ev)
        try:
            fire()
            if not done.wait(timeout_s):
                raise TimeoutError(f"{what} produced no result in time")
            return box[0]
        finally:
            sub.unsubscribe()

    def create_wallet_sync(
        self, wallet_id: str, timeout_s: float = 600.0
    ) -> wire.KeygenSuccessEvent:
        # keygen results land on per-wallet topics — subscribe to OUR
        # wallet's topic so concurrent clients never round-robin-steal
        # each other's results
        ev = self._await_result(
            lambda h: self.client.on_wallet_creation_result(
                h, wallet_id=wallet_id
            ),
            lambda: self.client.create_wallet(wallet_id),
            lambda ev: ev.wallet_id == wallet_id,
            timeout_s,
            f"wallet {wallet_id!r} creation",
        )
        if ev.result_type != wire.RESULT_SUCCESS:
            raise RuntimeError(f"keygen failed: {ev.error_reason}")
        return ev

    def sign_sync(
        self, msg: wire.SignTxMessage, timeout_s: float = 600.0
    ) -> wire.SigningResultEvent:
        return self._await_result(
            lambda h: self.client.on_sign_result(h, tx_id=msg.tx_id),
            lambda: self.client.sign_transaction(msg),
            lambda ev: ev.tx_id == msg.tx_id,
            timeout_s,
            f"tx {msg.tx_id!r}",
        )

    def reshare_sync(
        self, wallet_id: str, new_threshold: int, key_type: str,
        timeout_s: float = 600.0,
    ) -> wire.ResharingSuccessEvent:
        ev = self._await_result(
            lambda h: self.client.on_resharing_result(h, wallet_id=wallet_id),
            lambda: self.client.resharing(wallet_id, new_threshold, key_type),
            lambda ev: ev.wallet_id == wallet_id and ev.key_type == key_type,
            timeout_s,
            f"wallet {wallet_id!r} resharing",
        )
        if ev.result_type != wire.RESULT_SUCCESS:
            raise RuntimeError(f"resharing failed: {ev.error_reason}")
        return ev


class LocalCluster(SyncOps):
    """n identical in-process MPC nodes + a client over loopback or TCP."""

    def __init__(
        self,
        n_nodes: int = 3,
        threshold: int = 2,
        root_dir: Optional[str] = None,
        preparams: Optional[Dict[str, PreParams]] = None,
        store_password: str = "dev-password",
        min_paillier_bits: int = 2046,
        reply_timeout_s: float = 30.0,
        transport: str = "loopback",  # "loopback" | "tcp"
        batch_signing: bool = False,
        batch_window_s: float = 0.05,
        fault_plans: Optional[Dict] = None,  # node_id|"*"|"client" → FaultPlan
        broker_standby: bool = False,  # tcp only: hot-standby broker pair
        hello_timeout_s: Optional[float] = 20.0,
        session_timeout_s: Optional[float] = None,  # EventConsumer GC knobs
        gc_interval_s: Optional[float] = None,  # (chaos drills shrink both)
        session_wal: bool = False,  # encrypted per-round WAL + crash resume
        batch_max_batch: Optional[int] = None,  # SLO batching knobs (None =
        batch_deadline_ms: Optional[int] = None,  # config defaults; see
        batch_max_queue_depth: Optional[int] = None,  # config.py batch_*)
        batch_manifest_timeout_s: Optional[float] = None,
        device: DeviceLike = None,
    ):
        from .config import init_config

        # resolve first: a cluster without a card raises before it starts
        # a single thread (None means the GPU; tests pass "cpu")
        self.device = resolve(device)
        self.root = Path(root_dir or tempfile.mkdtemp(prefix="mpcium-tpu-torch-"))
        self.node_ids = [f"node{i}" for i in range(n_nodes)]
        # flight recorder is always on for clusters: bounded per-node ring
        # buffers, merged on demand by trace_snapshot(); incident dumps land
        # under the cluster root
        _trace_arm(node_ids=self.node_ids,
                   dump_dir=str(self.root / "trace_incidents"))
        # None overrides are skipped by init_config → config defaults apply
        cfg = init_config(path=str(self.root / "nonexistent.yaml"),
                          mpc_threshold=threshold,
                          batch_max_batch=batch_max_batch,
                          batch_deadline_ms=batch_deadline_ms,
                          batch_max_queue_depth=batch_max_queue_depth,
                          batch_manifest_timeout_s=batch_manifest_timeout_s)
        # each pool holds one thread per in-flight handler; a signing
        # request keeps one in the durable bridge until its batch answers,
        # so batched clusters size the pools for a full batch on each curve
        # (threads start only when a handler finds none idle)
        workers = 16
        if batch_signing:
            workers += 2 * cfg.batch_max_batch
        self.broker = None
        self.standby_broker = None
        self.fabric = None
        self._tcp: List[object] = []  # every TCP transport made, for close()
        if transport == "tcp":
            from .transport.tcp import BrokerServer

            self.broker = BrokerServer(port=0)
            standbys = None
            if broker_standby:
                self.standby_broker = BrokerServer(
                    port=0, follow=(self.broker.host, self.broker.port)
                )
                assert self.standby_broker._rep_synced.wait(10), (
                    "standby broker never synced to primary"
                )
                standbys = [(self.standby_broker.host,
                             self.standby_broker.port)]
            self._mk_transport = lambda: self._tcp_transport(standbys, workers)
        else:
            self.fabric = LoopbackFabric(workers=workers)
            self._mk_transport = self.fabric.transport
        # fault-injection seam (faults/): nodes with a plan get their
        # transport wrapped; with no plan nothing is constructed and
        # behavior is byte-identical to a bare cluster
        self._fault_plans = fault_plans or {}
        self.fault_transports: Dict[str, object] = {}
        self._retired_fault_transports: List[object] = []
        self._hello_timeout_s = hello_timeout_s
        self.control_kv = MemoryKV()  # the Consul analogue

        # identities (setup_identities.sh equivalent)
        ident_dir = self.root / "identity"
        for nid in self.node_ids:
            generate_identity(nid, ident_dir)
        self.initiator = InitiatorKey.generate()

        # per-node ctor state, retained so respawn_node() can rebuild a
        # killed node's runtime stack over its surviving on-disk state
        self._ident_dir = ident_dir
        self._peers = {nid: nid for nid in self.node_ids}
        self._store_password = store_password
        self._min_paillier_bits = min_paillier_bits
        self._preparams = preparams or {}
        self._session_wal = session_wal
        self._batch_signing = batch_signing
        self._batch_window_s = batch_window_s
        self._reply_timeout_s = reply_timeout_s
        self._ec_kw: Dict[str, float] = {}
        if session_timeout_s is not None:
            self._ec_kw["session_timeout_s"] = session_timeout_s
        if gc_interval_s is not None:
            self._ec_kw["gc_interval_s"] = gc_interval_s

        self.nodes: Dict[str, Node] = {}
        self.consumers: List[EventConsumer] = []
        self.signing_consumers: List[SigningConsumer] = []
        self.node_consumers: Dict[str, EventConsumer] = {}
        for nid in self.node_ids:
            self._spawn_node(nid)
        for node in self.nodes.values():
            assert node.registry.wait_all_ready(10), "cluster failed to form"
        log.info("local cluster ready", nodes=n_nodes, threshold=threshold,
                 device=str(self.device))
        self.client = MPCClient(
            self._wrap_faults("client", self._mk_transport()), self.initiator
        )

    def _spawn_node(self, nid: str) -> EventConsumer:
        """Build one node's full runtime stack — identity, encrypted share
        store (at its canonical on-disk path), optional session-WAL store,
        registry, transport, Node, consumers — exactly the daemon boot
        sequence. Used at cluster construction and by :meth:`respawn_node`."""
        identity = IdentityStore(
            self._ident_dir, nid, self._peers,
            initiator_pubkey=self.initiator.public_bytes,
        )
        kv = EncryptedFileKV(self.root / "db" / nid, self._store_password)
        wal = None
        if self._session_wal:
            from .store.session_wal import SessionWALStore

            wal = SessionWALStore(kv)
        registry = PeerRegistry(
            nid, self.node_ids, self.control_kv, poll_interval_s=0.05
        )
        transport = self._wrap_faults(nid, self._mk_transport())
        node = Node(
            node_id=nid,
            peer_ids=self.node_ids,
            transport=transport,
            identity=identity,
            kvstore=kv,
            keyinfo=KeyinfoStore(self.control_kv),
            registry=registry,
            preparams=self._preparams.get(nid),
            min_paillier_bits=self._min_paillier_bits,
            hello_timeout_s=self._hello_timeout_s,
            session_wal=wal,
            device=self.device,
        )
        self.nodes[nid] = node
        ec = EventConsumer(
            node, transport,
            batch_signing=self._batch_signing,
            batch_window_s=self._batch_window_s,
            device=self.device,
            **self._ec_kw,
        )
        ec.run()
        self.consumers.append(ec)
        self.node_consumers[nid] = ec
        sc = SigningConsumer(transport, reply_timeout_s=self._reply_timeout_s)
        sc.run()
        self.signing_consumers.append(sc)
        TimeoutConsumer(transport).run()
        registry.ready()
        return ec

    def _tcp_transport(self, standbys, workers: int):
        from .transport.tcp import tcp_transport

        t = tcp_transport(self.broker.host, self.broker.port,
                          standbys=standbys, workers=workers)
        self._tcp.append(t)
        return t

    def respawn_node(self, node_id: str) -> EventConsumer:
        """In-process 'restart after SIGKILL': rebuild ``node_id``'s entire
        runtime over its surviving on-disk state (identity keys, encrypted
        share store, session WALs) on the cluster's device, the way a
        fresh daemon boot would, then replay incomplete WAL sessions. The
        dead incarnation's objects are deliberately left in place — a
        killed process never cleans up; its crashed transport keeps
        black-holing whatever still reaches it."""
        old_ft = self.fault_transports.pop(node_id, None)
        if old_ft is not None:
            self._retired_fault_transports.append(old_ft)
        ec = self._spawn_node(node_id)
        # boot-time crash recovery, after ready() — mirrors daemon.run_node
        ec.resume_incomplete()
        return ec

    def _wrap_faults(self, owner: str, transport):
        """Wrap ``transport`` in a FaultyTransport when a fault plan is
        installed for ``owner`` (or under the "*" wildcard, which the
        client does not take). No plan ⇒ the bare transport passes
        through untouched."""
        plan = self._fault_plans.get(owner) or (
            self._fault_plans.get("*") if owner != "client" else None
        )
        if plan is None:
            return transport
        from .faults.transport import FaultyTransport

        ft = FaultyTransport(transport, owner, plan)
        self.fault_transports[owner] = ft
        return ft

    def health(self) -> Dict[str, dict]:
        """Per-node operational snapshots (EventConsumer.health): live
        sessions, dedup claims, and every scheduler metric — lane queue
        depths, shed counters, fill ratios, latency percentiles."""
        return {nid: ec.health() for nid, ec in self.node_consumers.items()}

    def metrics_snapshot(self) -> Dict[str, dict]:
        """Just the metric registries, keyed by node id."""
        return {
            nid: ec.metrics.snapshot()
            for nid, ec in self.node_consumers.items()
        }

    def trace_snapshot(self, clear: bool = False,
                       meta: Optional[dict] = None) -> dict:
        """Merge every node's flight-recorder ring buffer (plus the shared
        engine/client tracks) into one Chrome-trace-event JSON document —
        pid = node, tid = session/lane — loadable in Perfetto / chrome://
        tracing. Buffers survive :meth:`close`."""
        return _trace_snapshot_chrome(clear=clear, meta=meta)

    def prometheus_text(self) -> str:
        """Prometheus text exposition for the whole cluster: each node's
        registry rendered with a ``node`` label, concatenated."""
        return "".join(
            ec.metrics.to_prometheus(labels={"node": nid})
            for nid, ec in self.node_consumers.items()
        )

    def close(self, join_timeout_s: float = 10.0) -> None:
        for ec in self.consumers:
            try:
                ec.close()
            except Exception as e:  # noqa: BLE001
                log.warn("consumer close failed", error=repr(e))
        for sc in self.signing_consumers:
            sc.close()
        for node in self.nodes.values():
            node.registry.resign()
        for ft in list(self.fault_transports.values()) + \
                self._retired_fault_transports:
            ft.close()
        if self.fabric is not None:
            self.fabric.close()
        for t in self._tcp:
            t.client.close()
        for b in (self.broker, self.standby_broker):
            if b is not None:
                b.close()
        _trace_disarm()
        # the nodes' daemon workers end once their sessions and wheels are
        # closed; wait for them (bounded) so close() is a teardown barrier
        deadline = time.monotonic() + join_timeout_s
        me = threading.current_thread()
        for t in threading.enumerate():
            if t is not me and t.name.startswith(_WORKER_PREFIXES):
                t.join(max(0.0, deadline - time.monotonic()))


class RemoteCluster(SyncOps):
    """Client-side handle to an ALREADY RUNNING networked deployment
    (broker + daemons — the docker-compose topology): the analogue of the
    reference examples connecting to a live NATS+Consul stack
    (INSTALLATION.md "Start Mpcium Nodes"; examples/generate/main.go).

    Reads broker endpoint/auth/encryption from the same config file the
    daemons use and loads the initiator's PRIVATE key (default:
    ``event_initiator.key`` next to the config, the client.go:64-146
    layout). It computes nothing, so it takes no device."""

    def __init__(
        self,
        config_path: str,
        initiator_key_path: Optional[str] = None,
        passphrase: Optional[str] = None,
    ):
        from .config import init_config
        from .transport.tcp import parse_addrs, tcp_transport

        cfg = init_config(path=str(config_path))
        key_path = Path(
            initiator_key_path
            or Path(config_path).resolve().parent / "event_initiator.key"
        )
        # load the key BEFORE connecting: a missing/locked key must not
        # leak a live authenticated broker connection + reader thread
        initiator = InitiatorKey.load(key_path, passphrase)
        self.transport = tcp_transport(
            cfg.broker_host,
            cfg.broker_port,
            auth_token=cfg.broker_token or None,
            encrypt=cfg.broker_encrypt,
            standbys=parse_addrs(cfg.broker_standbys) or None,
        )
        self.client = MPCClient(self.transport, initiator)

    def close(self) -> None:
        self.transport.client.close()


def load_test_preparams(bits: int = 2048) -> Dict[str, PreParams]:
    """The committed fixtures (TEST/BENCH ONLY — production nodes generate
    fresh pre-params). ``bits=2048`` is the full-size key set,
    ``bits=1024`` the shrunk one of the fast tests; both are the port's
    own copies of the JAX package's ``data/test_preparams*.json``."""
    name = "test_preparams.json" if bits == 2048 else f"test_preparams_{bits}.json"
    with open(DATA / name) as f:
        d = json.load(f)["preparams"]
    return {k: PreParams.from_json(v) for k, v in d.items()}
