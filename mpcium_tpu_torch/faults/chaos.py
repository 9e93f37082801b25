"""Chaos drill runner: reproducible failure drills over a live cluster.

The port's copy of the JAX package's ``faults/chaos.py``. Each drill
stands up an in-process :class:`~..cluster.LocalCluster` (loopback or
TCP+standby) on an explicit ``device`` (None: the GPU, which raises when
there is none; tests pass ``"cpu"``), runs real protocol work — EdDSA
keygen → signing → resharing through the full client/queue/consumer path
— under a seed-deterministic :class:`~.plan.FaultPlan`, and emits a
structured :class:`DrillReport` with the JAX report's keys.
``scripts/torch_chaos_drill.py`` is the CLI.

Where the device is: the per-session EdDSA parties of the drills compute
in host python ints, as in the JAX package; the cheater drill's OT-MtA
leg (limbs from the port's ``core/bignum``) runs on ``device``, and the
kill-resume drill's warm pass signs its bucket there.

Drill catalog (expected outcome in parentheses):

- ``node-crash`` (recovered) — node2 SIGKILLs the instant it joins its
  first signing session; the tx fails LOUDLY, the committee detects the
  death via heartbeat staleness and signs with t+1 survivors, the node
  restarts, rejoins and signs again — then the wallet reshares cleanly.
- ``drop-jitter`` (success) — 10 % loss on every acked protocol unicast
  plus 50–200 ms jitter on all protocol traffic; the retry budgets
  absorb it and keygen → signing → reshare all complete.
- ``broker-failover`` (success) — TCP transport, hot-standby broker;
  the primary dies mid-run and clients transparently fail over.
- ``partition`` (loud-failure-then-recovery) — two of three nodes are
  isolated (over threshold: no quorum can form anywhere); signing fails
  loudly and retryably — a bounded timeout ERROR event, no hang, no
  silent corruption — and succeeds after the partition heals.
- ``kill-resume`` (resumed) — with the session WAL on, node2 SIGKILLs
  mid-round-2 of a signing session; the survivors stall (the quorum
  includes the corpse), the node respawns over its on-disk state, WAL
  replay re-claims the session and the SAME run completes with the
  bit-identical signature; the report carries ``resume_latency_s``.
- ``cheater`` (caught-and-quarantined) — an active adversary corrupts
  one PRF-chosen OT-MtA wire field in one batch lane mid-signing;
  the KOS / Gilboa / consistency checks catch the
  deviation and blame exactly the cheating party, the batch scheduler
  quarantines that one session behind a retryable culprit-named ABORT
  event and re-packs the survivors onto bucket-snapped sub-batches,
  while live EdDSA traffic keeps signing on a real cluster; the report
  carries ``culprit`` and ``survivors``.

Reproducing a failed drill: the report carries ``seed`` and the full
plan JSON; ``scripts/torch_chaos_drill.py --drill <name> --seed <seed>``
reruns the identical fault schedule (see plan.py's determinism contract).
"""
from __future__ import annotations

import hashlib
import shutil
import tempfile
import threading
import time
import types
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import wire
from ..cluster import LocalCluster, load_test_preparams
from ..device import DeviceLike
from ..trace import snapshot_chrome
from ..utils import log, tracing
from .plan import FaultPlan, named_plan
from .transport import FaultStats

DEFAULT_SEED = 7


@dataclass
class DrillReport:
    name: str
    seed: int
    expected: str
    outcome: str
    ok: bool
    duration_s: float
    plan: dict = field(default_factory=dict)
    faults: dict = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)
    error: str = ""
    # kill-resume: wall time from respawn to the resumed session's result
    resume_latency_s: float = 0.0
    # kill-resume: warm-cache stats from the pre-respawn warm pass
    # ({warmed, hits, budget_s} — warm.prewarm.warm_for_drill)
    warm: dict = field(default_factory=dict)
    # cheater: the blamed deviation ({session, lane, party, check, field})
    culprit: dict = field(default_factory=dict)
    # cheater: cohort completion stats after the quarantine
    # ({submitted, quarantined, completed, pending, chunks})
    survivors: dict = field(default_factory=dict)
    # merged cross-node Chrome-trace-event JSON (flight-recorder snapshot;
    # load in Perfetto / chrome://tracing)
    trace: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "expected": self.expected,
            "outcome": self.outcome,
            "ok": self.ok,
            "duration_s": round(self.duration_s, 3),
            "plan": self.plan,
            "faults": self.faults,
            "notes": self.notes,
            "error": self.error,
            "resume_latency_s": round(self.resume_latency_s, 3),
            "warm": self.warm,
            "culprit": self.culprit,
            "survivors": self.survivors,
            "trace": self.trace,
        }


def _wait(cond: Callable[[], bool], timeout_s: float,
          poll_s: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll_s)
    return False


# -- cluster plumbing --------------------------------------------------------


def _mk_cluster(fault_plans: Optional[Dict[str, FaultPlan]] = None,
                transport: str = "loopback",
                broker_standby: bool = False,
                hello_timeout_s: float = 4.0,
                reply_timeout_s: float = 6.0,
                session_timeout_s: float = 12.0,
                gc_interval_s: float = 1.0,
                session_wal: bool = False,
                device: DeviceLike = None) -> Tuple[LocalCluster, str]:
    """A 3-node t=1 drill cluster on ``device`` with tightened failure
    deadlines, so loud failures surface inside the drill budget instead
    of the production 30-minute GC."""
    root = tempfile.mkdtemp(prefix="mpcium-chaos-")
    cluster = LocalCluster(
        n_nodes=3,
        threshold=1,
        root_dir=root,
        preparams=load_test_preparams(bits=1024),
        transport=transport,
        broker_standby=broker_standby,
        fault_plans=fault_plans,
        hello_timeout_s=hello_timeout_s,
        reply_timeout_s=reply_timeout_s,
        session_timeout_s=session_timeout_s,
        gc_interval_s=gc_interval_s,
        session_wal=session_wal,
        device=device,
    )
    return cluster, root


def _close(cluster: LocalCluster, root: str) -> None:
    try:
        cluster.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _merged_stats(cluster: LocalCluster) -> FaultStats:
    merged = FaultStats()
    retired = getattr(cluster, "_retired_fault_transports", [])
    for ft in list(cluster.fault_transports.values()) + list(retired):
        merged.merge(ft.stats)
    return merged


def _eddsa_keygen(cluster: LocalCluster, wallet_id: str,
                  timeout_s: float = 60.0, attempts: int = 3) -> int:
    """EdDSA-only distributed keygen via direct sessions on every node
    (wallet creation through the client forces the heavyweight GG18
    curve too; drills exercise the failure machinery, not Paillier).
    Returns the number of attempts used."""
    from ..config import get_config

    threshold = get_config().mpc_threshold
    last_err: Optional[str] = None
    for attempt in range(1, attempts + 1):
        sessions = [
            node.create_keygen_session(
                wire.KEY_TYPE_ED25519, wallet_id, threshold
            )
            for node in cluster.nodes.values()
        ]
        for s in sessions:
            s.listen()
        ok = True
        for s in sessions:
            if not s.wait(timeout_s) or s.failed:
                ok = False
        for s in sessions:
            s.close()
        if ok:
            return attempt
        last_err = "; ".join(
            s.session_id for s in sessions if s.failed
        ) or "timeout"
        log.warn("drill keygen attempt failed; retrying",
                 wallet=wallet_id, attempt=attempt, detail=last_err)
    raise RuntimeError(
        f"eddsa keygen for {wallet_id!r} failed after {attempts} "
        f"attempts: {last_err}"
    )


def _sign(cluster: LocalCluster, wallet_id: str, tx_id: str,
          timeout_s: float = 60.0) -> wire.SigningResultEvent:
    return cluster.sign_sync(
        wire.SignTxMessage(
            key_type=wire.KEY_TYPE_ED25519,
            wallet_id=wallet_id,
            network_internal_code="chaos",
            tx_id=tx_id,
            tx=b"chaos:" + tx_id.encode(),
        ),
        timeout_s=timeout_s,
    )


def _sign_retrying(cluster: LocalCluster, wallet_id: str, tx_base: str,
                   notes: List[str], attempts: int = 3,
                   timeout_s: float = 60.0) -> wire.SigningResultEvent:
    """Client-level retry: terminal errors and timeouts re-submit under a
    FRESH tx id (result queues are idempotent per tx id — a retry that
    reused the id of a failed tx would have its success deduped against
    the old error event)."""
    last: Optional[wire.SigningResultEvent] = None
    for attempt in range(1, attempts + 1):
        tx_id = tx_base if attempt == 1 else f"{tx_base}~retry{attempt - 1}"
        try:
            ev = _sign(cluster, wallet_id, tx_id, timeout_s=timeout_s)
        except TimeoutError as e:
            notes.append(f"{tx_id}: client-side timeout ({e})")
            continue
        except Exception as e:  # noqa: BLE001 — e.g. enqueue during failover
            notes.append(f"{tx_id}: submit failed retryably ({e!r})")
            time.sleep(0.5)
            continue
        if ev.result_type == wire.RESULT_SUCCESS:
            if attempt > 1:
                notes.append(f"{tx_base}: succeeded on attempt {attempt}")
            return ev
        last = ev
        notes.append(f"{tx_id}: ERROR ({ev.error_reason!r}); retrying")
    raise RuntimeError(
        f"signing {tx_base!r} failed after {attempts} attempts: "
        f"{last.error_reason if last else 'no result'}"
    )


def _reshare(cluster: LocalCluster, wallet_id: str,
             timeout_s: float = 60.0) -> wire.ResharingSuccessEvent:
    return cluster.reshare_sync(
        wallet_id, new_threshold=1, key_type=wire.KEY_TYPE_ED25519,
        timeout_s=timeout_s,
    )


# -- node lifecycle (SIGKILL semantics) --------------------------------------


def _stop_heartbeat(node) -> None:
    """The process is dead: heartbeats stop, the ready key is NOT
    resigned — peers must detect the death via heartbeat staleness (the
    registry's change-based liveness), exactly like a real SIGKILL."""
    reg = node.registry
    reg._registered = False
    reg._stop.set()


def kill_node(cluster: LocalCluster, node_id: str) -> None:
    """Crash a node mid-protocol: its transport goes silent both ways
    and its registry heartbeat stops."""
    ft = cluster.fault_transports.get(node_id)
    if ft is None:
        raise KeyError(
            f"{node_id!r} has no FaultyTransport — install a fault plan "
            f"for it (LocalCluster fault_plans)"
        )
    _stop_heartbeat(cluster.nodes[node_id])
    ft.crash_switch.crash()


def restart_node(cluster: LocalCluster, node_id: str) -> None:
    """Bring a crashed node back: transport restored, registry re-arms
    its heartbeat and watch loop, readiness re-announced."""
    node = cluster.nodes[node_id]
    ft = cluster.fault_transports[node_id]
    ft.crash_switch.restore()
    reg = node.registry
    if reg._thread is not None:
        reg._thread.join(timeout=2.0)
        reg._thread = None
    reg._stop = threading.Event()
    reg.watch()
    reg.ready()


# -- the drills --------------------------------------------------------------


def _drill_node_crash(seed: int, scale: float,
                      device: DeviceLike) -> Tuple[str, bool, List[str], dict, dict]:
    plan = named_plan("node-crash", seed)
    notes: List[str] = []
    cluster, root = _mk_cluster({"node2": plan}, device=device)
    try:
        # the crash rule fires inside the transport; SIGKILL semantics
        # need the heartbeat stopped at the same instant
        ft = cluster.fault_transports["node2"]
        ft.crash_switch.on_crash(
            lambda n=cluster.nodes["node2"]: _stop_heartbeat(n)
        )
        _eddsa_keygen(cluster, "w-crash")
        notes.append("keygen complete on all 3 nodes")

        # tx-c0 triggers the crash: node2 dies the moment it announces
        # itself in the signing session. The attempt must fail LOUDLY
        # (bounded ERROR event), never hang.
        try:
            ev0 = _sign(cluster, "w-crash", "tx-c0", timeout_s=60.0)
            loud = ev0.result_type == wire.RESULT_ERROR
            notes.append(
                f"tx-c0 under crash: {ev0.result_type} "
                f"({ev0.error_reason!r})"
            )
        except TimeoutError:
            loud = False
            notes.append("tx-c0 HUNG — no loud failure within budget")
        if not ft.crash_switch.crashed:
            notes.append("crash rule never fired")
            return "crash-not-triggered", False, notes, plan.to_json(), {}

        # survivors must notice the death (heartbeat staleness) ...
        survivors = ("node0", "node1")
        noticed = _wait(
            lambda: all(
                not cluster.nodes[n].registry.is_peer_ready("node2")
                for n in survivors
            ),
            timeout_s=15.0,
        )
        notes.append(f"death detected by survivors: {noticed}")
        # ... and sign with t+1 = 2 of 3
        ev1 = _sign_retrying(cluster, "w-crash", "tx-c1", notes)
        notes.append("signed with one node down")

        # restart: the node rejoins and the full committee signs again,
        # then the wallet reshares cleanly on the recovered cluster
        restart_node(cluster, "node2")
        rejoined = _wait(
            lambda: cluster.nodes["node0"].registry.is_peer_ready("node2"),
            timeout_s=15.0,
        )
        notes.append(f"node2 rejoined after restart: {rejoined}")
        ev2 = _sign_retrying(cluster, "w-crash", "tx-c2", notes)
        _reshare(cluster, "w-crash")
        ev3 = _sign_retrying(cluster, "w-crash", "tx-c3", notes)
        notes.append("post-restart sign + reshare + sign complete")

        ok = (loud and noticed and rejoined
              and ev1.result_type == wire.RESULT_SUCCESS
              and ev2.result_type == wire.RESULT_SUCCESS
              and ev3.result_type == wire.RESULT_SUCCESS)
        return ("recovered" if ok else "degraded", ok, notes,
                plan.to_json(), _merged_stats(cluster).to_json())
    finally:
        _close(cluster, root)


def _drill_drop_jitter(seed: int, scale: float,
                       device: DeviceLike) -> Tuple[str, bool, List[str], dict, dict]:
    plan = named_plan("drop-jitter", seed, scale=scale)
    notes: List[str] = []
    cluster, root = _mk_cluster({"*": plan}, device=device)
    try:
        attempts = _eddsa_keygen(cluster, "w-dj")
        notes.append(f"keygen complete (attempt {attempts})")
        for i in range(3):
            ev = _sign_retrying(cluster, "w-dj", f"tx-dj{i}", notes)
            assert ev.result_type == wire.RESULT_SUCCESS
        notes.append("3 signatures under 10% unicast loss + jitter")
        _reshare(cluster, "w-dj")
        ev = _sign_retrying(cluster, "w-dj", "tx-dj-post-rs", notes)
        notes.append("reshare + post-reshare signature complete")
        stats = _merged_stats(cluster)
        faults = stats.to_json()
        notes.append(
            f"faults injected: {faults['counters']}; "
            f"unicast losses absorbed by retries: {stats.retries_observed}"
        )
        ok = ev.result_type == wire.RESULT_SUCCESS
        return ("success" if ok else "failed", ok, notes,
                plan.to_json(), faults)
    finally:
        _close(cluster, root)


def _drill_broker_failover(seed: int, scale: float,
                           device: DeviceLike) -> Tuple[str, bool, List[str], dict, dict]:
    plan = named_plan("broker-failover", seed)
    notes: List[str] = []
    cluster, root = _mk_cluster(
        {}, transport="tcp", broker_standby=True, reply_timeout_s=8.0,
        device=device,
    )
    try:
        _eddsa_keygen(cluster, "w-bf")
        ev = _sign(cluster, "w-bf", "tx-bf0", timeout_s=60.0)
        assert ev.result_type == wire.RESULT_SUCCESS, ev.error_reason
        notes.append("keygen + baseline signature over primary broker")

        cluster.broker.close()
        notes.append("primary broker killed mid-run")
        # every client walks its address list to the standby and replays
        # subscriptions; the first post-failover submits can land in a
        # dead socket buffer, so the client-level retry does the rest
        ev = _sign_retrying(cluster, "w-bf", "tx-bf1", notes,
                            attempts=4, timeout_s=30.0)
        notes.append("signature completed via standby broker")
        ok = ev.result_type == wire.RESULT_SUCCESS
        return ("success" if ok else "failed", ok, notes,
                plan.to_json(), _merged_stats(cluster).to_json())
    finally:
        _close(cluster, root)


def _drill_partition(seed: int, scale: float,
                     device: DeviceLike) -> Tuple[str, bool, List[str], dict, dict]:
    plan = named_plan("partition", seed)
    notes: List[str] = []
    cluster, root = _mk_cluster(
        {"*": plan}, hello_timeout_s=3.0, reply_timeout_s=4.0,
        session_timeout_s=8.0, device=device,
    )
    try:
        _eddsa_keygen(cluster, "w-p")
        ev = _sign(cluster, "w-p", "tx-p0", timeout_s=60.0)
        assert ev.result_type == wire.RESULT_SUCCESS, ev.error_reason
        notes.append("keygen + baseline signature pre-partition")

        plan.activate()  # partition node1+node2: over threshold, no quorum
        t0 = time.monotonic()
        try:
            ev1 = _sign(cluster, "w-p", "tx-p1", timeout_s=90.0)
            loud = ev1.result_type == wire.RESULT_ERROR
            notes.append(
                f"tx-p1 under partition: {ev1.result_type} after "
                f"{time.monotonic() - t0:.1f}s "
                f"(timeout={getattr(ev1, 'is_timeout', False)}, "
                f"reason={ev1.error_reason!r})"
            )
        except TimeoutError:
            loud = False
            notes.append("tx-p1 HUNG under partition — drill failed")

        plan.heal()
        notes.append("partition healed")
        ev2 = _sign_retrying(cluster, "w-p", "tx-p2", notes)
        ok = loud and ev2.result_type == wire.RESULT_SUCCESS
        notes.append("post-heal signature complete")
        return ("loud-failure-then-recovery" if ok else "degraded", ok,
                notes, plan.to_json(), _merged_stats(cluster).to_json())
    finally:
        _close(cluster, root)


def _drill_kill_resume(seed: int, scale: float, device: DeviceLike):
    """SIGKILL mid-round-2, restart, SAME session completes.

    node2's fault plan crashes it the instant its round-2 decommitment
    broadcast leaves (the WAL already holds the round-2 checkpoint —
    checkpoint-before-route). Survivors stall: the signing quorum includes
    the corpse, so no 2-of-3 fallback exists for THIS session. The drill
    then respawns node2 over its surviving on-disk state; boot-time WAL
    replay must re-claim the session, answer the ``__resume__`` handshake
    and finish with the bit-identical signature on every node.
    """
    from ..core import hostmath as hm
    from ..warm.prewarm import warm_for_drill
    from .plan import crash_node

    # warm the drill's signing bucket BEFORE any session is live (a warm
    # pass mid-drill would stall the survivors past their round
    # timeouts) so resume_latency_s measures recovery, not first-use
    # costs — the warm stats ride the report beside it
    warm_stats = warm_for_drill(device=device)
    plan = FaultPlan(
        seed, [crash_node("node2", at_round="eddsa/sign/2", topic="sign:*")]
    )
    notes: List[str] = []
    cluster, root = _mk_cluster({"node2": plan}, session_wal=True,
                                device=device)
    try:
        ft = cluster.fault_transports["node2"]
        ft.crash_switch.on_crash(
            lambda n=cluster.nodes["node2"]: _stop_heartbeat(n)
        )
        _eddsa_keygen(cluster, "w-kr")
        notes.append("keygen complete on all 3 nodes")
        pub = bytes.fromhex(
            cluster.nodes["node0"].keyinfo
            .get(wire.KEY_TYPE_ED25519, "w-kr").public_key
        )

        box: dict = {}

        def signer():
            try:
                box["ev"] = _sign(cluster, "w-kr", "tx-kr0", timeout_s=90.0)
            except Exception as e:  # noqa: BLE001 — surfaced via the box
                box["err"] = e
            box["t_done"] = time.monotonic()

        th = threading.Thread(target=signer, daemon=True)
        th.start()

        if not _wait(lambda: ft.crash_switch.crashed, timeout_s=30.0):
            notes.append("crash rule never fired")
            return "crash-not-triggered", False, notes, plan.to_json(), {}
        notes.append("node2 SIGKILLed on its round-2 broadcast")

        # hold the survivors' stalled Session objects so their in-memory
        # results can be compared bit-for-bit after recovery
        dedup = "w-kr-tx-kr0"
        held: Dict[str, object] = {}
        for nid in ("node0", "node1"):
            ec = cluster.node_consumers[nid]
            with ec._lock:
                ss = list(ec._sessions.get(dedup) or [])
            if ss:
                held[nid] = ss[0]
        stalled = len(held) == 2 and all(not s.done for s in held.values())
        notes.append(f"survivor sessions stalled mid-round: {stalled}")

        time.sleep(0.5)  # everything node2 says next must be WAL replay
        t_respawn = time.monotonic()
        new_ec = cluster.respawn_node("node2")
        with new_ec._lock:
            ss = list(new_ec._sessions.get(dedup) or [])
        if ss:
            held["node2"] = ss[0]
        notes.append(f"node2 respawned; WAL session re-claimed: {bool(ss)}")

        th.join(90.0)
        faults = _merged_stats(cluster).to_json()
        if "ev" not in box:
            notes.append(
                f"signing never completed after respawn "
                f"({box.get('err')!r})"
            )
            return "hung", False, notes, plan.to_json(), faults
        ev = box["ev"]
        resume_latency = box["t_done"] - t_respawn
        notes.append(
            f"tx-kr0: {ev.result_type} {resume_latency:.2f}s after respawn"
        )
        sig_ok = (
            ev.result_type == wire.RESULT_SUCCESS
            and hm.ed25519_verify(
                pub, b"chaos:tx-kr0", bytes.fromhex(ev.signature)
            )
        )
        notes.append(f"signature verifies under the wallet key: {sig_ok}")
        # the client event comes from whichever node finished FIRST (the
        # per-tx result queue dedups the rest) — give the other parties a
        # beat to cross their own finish line before comparing bytes
        _wait(lambda: all(s.done for s in held.values()), timeout_s=10.0)
        results = {
            nid: s.party.result.hex()
            for nid, s in held.items()
            if s.party.result is not None
        }
        identical = (
            len(results) == 3
            and len(set(results.values())) == 1
            and ev.signature in results.values()
        )
        notes.append(
            f"bit-identical signature on {sorted(results)}: {identical}"
        )
        # the result event fires from on_done, which runs BEFORE the WAL
        # drop in Session._finish — poll instead of instant-checking
        wal_drained = _wait(
            lambda: not cluster.nodes["node2"].session_wal.incomplete(),
            timeout_s=5.0,
        )
        notes.append(f"node2 WAL drained after completion: {wal_drained}")
        ok = stalled and sig_ok and identical and wal_drained
        return ("resumed" if ok else "degraded", ok, notes, plan.to_json(),
                faults,
                {"resume_latency_s": resume_latency, "warm": warm_stats})
    finally:
        _close(cluster, root)


class _DetRng:
    """Deterministic CSPRNG stand-in for the cheater drill's synthetic
    OT legs: a hash-counter stream, so the same seed draws identical
    bytes in identical call order (the JAX drill's stream, byte for
    byte — the drill must be reproducible from its seed)."""

    def __init__(self, seed: int):
        self.seed = seed
        self.ctr = 0

    def token_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += hashlib.sha256(
                b"chaos-rng|%d|%d" % (self.seed, self.ctr)
            ).digest()
            self.ctr += 1
        return bytes(out[:n])

    def randbelow(self, n: int) -> int:
        return int.from_bytes(self.token_bytes(40), "big") % n


def _synth_ot_leg(seed: int, device: DeviceLike = None):
    """OTMtALeg on ``device`` with synthetic base-OT material satisfying
    the base-OT postcondition (keysD[j] = k^{Δ_j}_j), skipping the curve
    ladders. Keys, delta and the 8-byte tag are the JAX drill's."""
    import numpy as np

    from ..protocol.ecdsa import mta_ot

    rng = _DetRng(seed)
    k0 = np.frombuffer(
        rng.token_bytes(mta_ot.KAPPA * 32), np.uint8
    ).reshape(-1, 32).copy()
    k1 = np.frombuffer(
        rng.token_bytes(mta_ot.KAPPA * 32), np.uint8
    ).reshape(-1, 32).copy()
    delta = np.frombuffer(rng.token_bytes(mta_ot.KAPPA), np.uint8) & 1
    return mta_ot.OTMtALeg.from_base_ot(
        b"drill-|%d" % (seed % 10), k0, k1, delta,
        rng=_DetRng(seed + 1000), device=device,
    )


CHEAT_B = 4  # the batch lanes of the drill's OT leg (the JAX drill's)


def _cheat_spec(plan: FaultPlan, B: int = CHEAT_B) -> Tuple[dict, str, str]:
    """The deviation the cheater 'chooses', all PRF draws of ``plan``'s
    tamper rule: (spec for ``OTMtALeg.set_tamper``, the party the checks
    must blame, the check that must catch it)."""
    from ..protocol.ecdsa import mta_ot

    rule = plan.rules[0]
    # the corruption surfaces an active cheater controls, and the check
    # that MUST catch each (with the party its failure blames)
    surfaces = (
        ("U", None, "alice", mta_ot.CHECK_KOS),
        ("kos_tbar", None, "alice", mta_ot.CHECK_KOS),
        ("y1", 0, "bob", mta_ot.CHECK_GILBOA),
        ("D", 1, "bob", mta_ot.CHECK_GILBOA),
        ("B_pt", 0, "bob", mta_ot.CHECK_GILBOA),
        ("Beta_pt", 1, "bob", mta_ot.CHECK_CONSISTENCY),
    )
    lane = int(plan._u(rule, b"cheat", 0, lane="lane") * B)
    field_, set_idx, role, check = surfaces[
        int(plan._u(rule, b"cheat", 0, lane="field") * len(surfaces))
    ]
    spec = {
        "field": field_, "lane": lane,
        "byte": int(plan._u(rule, b"cheat", 0, lane="byte") * 4096),
        "xor": 1 + int(plan._u(rule, b"cheat", 0, lane="xor") * 255),
    }
    if set_idx is not None:
        spec["set"] = set_idx
    return spec, role, check


def _cheat_scalars(seed: int, B: int = CHEAT_B) -> Tuple[list, list, list]:
    """The leg's scalars (a; Bob's g, w), nonzero: b ≡ 0 encodes the
    identity garbage (the 2^-256 caveat SECURITY.md documents) and would
    mis-frame the drill's blame assertion."""
    from ..protocol.ecdsa import mta_ot

    Q = mta_ot.Q
    r = _DetRng(seed + 31)
    a = [r.randbelow(Q - 1) + 1 for _ in range(B)]
    g = [r.randbelow(Q - 1) + 1 for _ in range(B)]
    w = [r.randbelow(Q - 1) + 1 for _ in range(B)]
    return a, g, w


def _drill_cheater(seed: int, scale: float, device: DeviceLike):
    """Active deviation caught, blamed and absorbed under live traffic.

    Everything the cheater 'chooses' — which batch lane, which OT-MtA
    wire field (hence which check must catch it and which party is to
    blame), which byte, which xor mask — is a PRF draw from the named
    ``cheater`` plan, so the identical deviation replays from (seed,
    plan) alone. The corruption is injected protocol-level
    (``OTMtALeg.set_tamper``: the OT rounds never cross the transport
    in the in-process engine) into a leg on ``device``; the scheduler
    half drives the REAL quarantine machinery (``_absorb_cohort_abort``:
    retryable culprit-named ABORT event, claim handoff, bucket-snapped
    re-pack) with a recording engine stub. A live 3-node cluster keeps
    signing EdDSA traffic throughout."""
    import json

    import torch

    from ..consumers.batch_scheduler import BatchSigningScheduler
    from ..core import bignum as bn
    from ..core.bignum import P256
    from ..device import resolve
    from ..engine.abort import CohortAbort
    from ..protocol.ecdsa import mta_ot
    from ..transport.loopback import LoopbackFabric

    dev = resolve(device)
    plan = named_plan("cheater", seed)
    notes: List[str] = []
    B = CHEAT_B
    Q = mta_ot.Q
    spec, role, check = _cheat_spec(plan, B)
    lane, field_ = spec["lane"], spec["field"]
    notes.append(
        f"PRF-derived deviation: field={field_} lane={lane} "
        f"byte={spec['byte']} xor={spec['xor']:#x} "
        f"(must blame {role} via {check!r})"
    )

    cluster, root = _mk_cluster(device=dev)
    try:
        _eddsa_keygen(cluster, "w-ch")
        ev0 = _sign(cluster, "w-ch", "tx-ch0", timeout_s=60.0)
        assert ev0.result_type == wire.RESULT_SUCCESS, ev0.error_reason
        notes.append("keygen + baseline signature (live traffic up)")

        # live traffic rides concurrently with the cheat-and-catch
        live: dict = {}

        def _live_signer():
            try:
                live["ev"] = _sign_retrying(
                    cluster, "w-ch", "tx-ch-live", notes
                )
            except Exception as e:  # noqa: BLE001 — surfaced via the box
                live["err"] = e

        live_th = threading.Thread(target=_live_signer, daemon=True)
        live_th.start()

        # -- the deviation, and the checks catching it --------------------
        def _limbs(vals):
            return torch.as_tensor(bn.batch_to_limbs(vals, P256), device=dev)

        a, g, w = _cheat_scalars(seed, B)
        leg = _synth_ot_leg(seed, dev)
        leg.set_tamper(spec)
        leg.run_multi(_limbs(a), (_limbs(g), _limbs(w)))
        blames = leg.check_blame()
        caught = blames is not None and blames[lane] == (role, check)
        misblamed = [
            i for i, bl in enumerate(blames or [])
            if i != lane and bl is not None
        ]
        notes.append(f"blame vector: {blames}")
        if not caught or misblamed:
            notes.append(
                f"deviation NOT attributed cleanly (caught={caught}, "
                f"misblamed lanes={misblamed})"
            )
            return ("undetected", False, notes, plan.to_json(),
                    _merged_stats(cluster).to_json())

        # -- the quarantine: real scheduler machinery ---------------------
        survivors_expected = B - 1
        completed: List[Tuple[str, List[str]]] = []
        all_done = threading.Event()

        class _RecordingScheduler(BatchSigningScheduler):
            def _run_batch(self, batch_id, reqs, *mid, **kw):
                completed.append((batch_id, [m.tx_id for m, _r in reqs]))
                if sum(len(t) for _b, t in completed) >= survivors_expected:
                    all_done.set()

        fab = LoopbackFabric()
        t = fab.transport()
        events: List[wire.SigningResultEvent] = []
        ev_lock = threading.Lock()

        def _on_result(data: bytes) -> None:
            with ev_lock:
                events.append(
                    wire.SigningResultEvent.from_json(json.loads(data))
                )

        sub = t.queues.dequeue(f"{wire.TOPIC_SIGNING_RESULT}.*", _on_result)
        sched = _RecordingScheduler(
            types.SimpleNamespace(node_id="drill0", peer_ids=["drill0"]),
            transport=t, device=dev,
        )
        reqs = [
            (wire.SignTxMessage(
                key_type="ecdsa", wallet_id=f"w-co{i}",
                network_internal_code="chaos", tx_id=f"tx-co{i}",
                tx=b"cohort:%d" % i,
            ), "")
            for i in range(B)
        ]
        try:
            abort = CohortAbort([(lane, role, check)], engine="gg18.sign")
            sched._absorb_cohort_abort("bdrill", reqs, frozenset(),
                                       abort.culprits)
            absorbed = all_done.wait(15.0)
            fab.drain(timeout_s=15.0)
        finally:
            sub.unsubscribe()
            sched.close()
            fab.close()

        quarantined = [
            e for e in events if e.tx_id == reqs[lane][0].tx_id
        ]
        abort_named = (
            len(quarantined) == 1
            and quarantined[0].result_type == wire.RESULT_ERROR
            and quarantined[0].retryable
            and role in quarantined[0].error_reason
            and check in quarantined[0].error_reason
        )
        survivor_txs = sorted(
            tx for _b, txs in completed for tx in txs
        )
        expect_txs = sorted(
            m.tx_id for i, (m, _r) in enumerate(reqs) if i != lane
        )
        chunks = [len(txs) for _b, txs in completed]
        pow2 = all(n & (n - 1) == 0 for n in chunks)
        notes.append(
            f"quarantine: {len(quarantined)} retryable ABORT event(s) "
            f"naming ({role}, {check!r}); survivors re-packed into "
            f"pow-2 chunks {chunks}"
        )
        invariant = (
            absorbed and survivor_txs == expect_txs
            and len(survivor_txs) + len(quarantined) == B
        )
        notes.append(
            f"cohort invariant: submitted={B} = completed="
            f"{len(survivor_txs)} + quarantined={len(quarantined)}, "
            f"pending={B - len(survivor_txs) - len(quarantined)}"
        )

        # -- survivors complete: honest re-run at the same batch shape ----
        leg.set_tamper(None)
        out2 = leg.run_multi(_limbs(a), (_limbs(g), _limbs(w)))
        blames2 = leg.check_blame()
        clean = blames2 is not None and all(bl is None for bl in blames2)
        leg_devs = sorted({x.device.type for pair in out2 for x in pair})
        on_dev = leg_devs == [dev.type]
        notes.append(f"OT leg device: {','.join(leg_devs)}")
        shares_ok = True
        for (al, be), b_ints in zip(out2, (g, w)):
            ai = bn.batch_from_limbs(al.cpu().numpy(), P256)
            bi = bn.batch_from_limbs(be.cpu().numpy(), P256)
            shares_ok &= all(
                (ai[i] + bi[i]) % Q == a[i] * b_ints[i] % Q
                for i in range(B)
            )
        notes.append(
            f"honest re-run: checks clean={clean}, MtA shares "
            f"valid={shares_ok}"
        )

        live_th.join(90.0)
        live_ok = (
            "ev" in live
            and live["ev"].result_type == wire.RESULT_SUCCESS
        )
        notes.append(f"live traffic kept signing throughout: {live_ok}")

        ok = (caught and not misblamed and abort_named and invariant
              and clean and on_dev and shares_ok and live_ok)
        culprit = {
            "session": reqs[lane][0].tx_id, "lane": lane,
            "party": role, "check": check, "field": field_,
        }
        survivors = {
            "submitted": B, "quarantined": len(quarantined),
            "completed": len(survivor_txs),
            "pending": B - len(survivor_txs) - len(quarantined),
            "chunks": chunks if pow2 else chunks + ["NOT-POW2"],
        }
        return ("caught-and-quarantined" if ok else "leaked", ok, notes,
                plan.to_json(), _merged_stats(cluster).to_json(),
                {"culprit": culprit, "survivors": survivors})
    finally:
        _close(cluster, root)


DRILLS: Dict[str, Tuple[Callable, str]] = {
    "node-crash": (_drill_node_crash, "recovered"),
    "drop-jitter": (_drill_drop_jitter, "success"),
    "broker-failover": (_drill_broker_failover, "success"),
    "partition": (_drill_partition, "loud-failure-then-recovery"),
    "kill-resume": (_drill_kill_resume, "resumed"),
    "cheater": (_drill_cheater, "caught-and-quarantined"),
}


def run_drill(name: str, seed: int = DEFAULT_SEED, scale: float = 1.0,
              device: DeviceLike = None) -> DrillReport:
    """Run one named drill on ``device`` (None: the GPU); never raises
    past the name check — failures, a missing GPU among them, land in the
    report."""
    if name not in DRILLS:
        raise KeyError(f"unknown drill {name!r}; have {sorted(DRILLS)}")
    fn, expected = DRILLS[name]
    t0 = time.monotonic()
    extra: dict = {}
    try:
        res = fn(seed, scale, device)
        outcome, ok, notes, plan_json, faults = res[:5]
        if len(res) > 5:  # optional per-drill metrics (resume_latency_s)
            extra = res[5]
        err = ""
    except Exception as e:  # noqa: BLE001 — report, don't crash the runner
        outcome, ok, notes, plan_json, faults = "error", False, [], {}, {}
        err = repr(e)
    # flight-recorder buffers survive cluster close — merge every node's
    # ring into one Perfetto-loadable document for the report; a failed
    # drill also drops an incident dump (dir set by the drill's cluster,
    # so it only survives when the operator keeps the root)
    if not ok:
        tracing.incident("drill-failure", node="local", drill=name,
                         outcome=outcome)
    trace_doc = snapshot_chrome(
        clear=True, meta={"drill": name, "seed": seed, "outcome": outcome},
    )
    return DrillReport(
        name=name, seed=seed, expected=expected, outcome=outcome, ok=ok,
        duration_s=time.monotonic() - t0, plan=plan_json, faults=faults,
        notes=notes, error=err, trace=trace_doc, **extra,
    )


def run_all(seed: int = DEFAULT_SEED, scale: float = 1.0,
            device: DeviceLike = None) -> List[DrillReport]:
    return [run_drill(name, seed=seed, scale=scale, device=device)
            for name in DRILLS]
