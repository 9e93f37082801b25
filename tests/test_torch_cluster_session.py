"""The port's per-session serving path on the CPU, and the wire shared
with the JAX package:

- ``LocalCluster(batch_signing=False, session_wal=True, device="cpu")``:
  ed25519 wallets made by ``EDDSAKeygenParty`` and saved into the nodes'
  stores (the client's keygen would also run a 1024-bit GG18 keygen per
  wallet on the host) are signed through the
  client by per-session ``EDDSASigningParty`` sessions, rotated by
  per-session ``ResharingParty`` sessions (keys kept, epoch 1) and signed
  again; every signature verifies on the host and every session's WAL is
  gone when it completes.
- A mixed committee on one loopback fabric: a JAX ``Node`` (node0) and
  two port ``Node``s (node1, node2) run per-session EdDSA keygen, a
  sign, a reshare and a sign again over signed envelopes. Both packages'
  parties are host python, so nothing compiles.
"""
from __future__ import annotations

import json
import threading
import time

import pytest

from mpcium_tpu.core.paillier import PreParams as JaxPreParams
from mpcium_tpu.identity import identity as jid
from mpcium_tpu.node.node import Node as JaxNode
from mpcium_tpu.registry.registry import PeerRegistry as JaxRegistry
from mpcium_tpu.store import keyinfo as jki
from mpcium_tpu.store import kvstore as jkv

from mpcium_tpu_torch import wire
from mpcium_tpu_torch.cluster import DATA, LocalCluster, load_test_preparams
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.identity import identity as pid
from mpcium_tpu_torch.node.node import Node
from mpcium_tpu_torch.protocol.eddsa.keygen import EDDSAKeygenParty
from mpcium_tpu_torch.protocol.runner import run_protocol
from mpcium_tpu_torch.registry.registry import PeerRegistry
from mpcium_tpu_torch.store import keyinfo as pki
from mpcium_tpu_torch.store import kvstore as pkv
from mpcium_tpu_torch.transport.loopback import LoopbackFabric
from mpcium_tpu_torch.utils.rng import SeededStream

IDS = ["node0", "node1", "node2"]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = LocalCluster(n_nodes=3, threshold=1, root_dir=str(tmp_path_factory.mktemp("session")),
                     preparams=load_test_preparams(1024), min_paillier_bits=1020,
                     batch_signing=False, session_wal=True, device="cpu")
    yield c
    c.close()


def _wal_files(cluster):
    return sorted(p.name for node in cluster.nodes.values()
                  for p in node.session_wal.dir.glob("*.wal"))


def _settle(cluster, limit_s: float = 30.0):
    deadline = time.monotonic() + limit_s
    while any(ec._sessions for ec in cluster.consumers) or _wal_files(cluster):
        assert time.monotonic() < deadline, [sorted(ec._sessions) for ec in cluster.consumers]
        time.sleep(0.05)


def test_per_session_eddsa_sign_rotate_sign_through_the_client(cluster):
    wallets = {}
    for w in range(2):
        parties = {nid: EDDSAKeygenParty(f"keygen:eddsa:ps{w}", nid, IDS, 1,
                                         rng=SeededStream(31 + 3 * w + i))
                   for i, nid in enumerate(IDS)}
        run_protocol(parties)
        for nid, party in parties.items():
            cluster.nodes[nid].save_share(party.result, f"ps{w}")
        wallets[f"ps{w}"] = parties["node0"].result.public_key

    def sign_all(tag):
        for w, pub in wallets.items():
            tx = f"{tag}-{w}".encode() * 3
            ev = cluster.sign_sync(wire.SignTxMessage("ed25519", w, "sol", f"{tag}-{w}", tx),
                                   timeout_s=120)
            assert ev.result_type == wire.RESULT_SUCCESS, ev.error_reason
            assert hm.ed25519_verify(pub, tx, bytes.fromhex(ev.signature))
        _settle(cluster)

    sign_all("t1")
    for w, pub in wallets.items():
        ev = cluster.reshare_sync(w, 1, "ed25519", timeout_s=120)
        assert bytes.fromhex(ev.pub_key) == pub
    _settle(cluster)
    for w in wallets:
        for node in cluster.nodes.values():
            assert node.load_share("ed25519", w).epoch == 1
    sign_all("t2")
    assert _wal_files(cluster) == []
    for nid, h in cluster.health().items():
        assert not h["batch_signing"] and h["live_sessions"] == 0, (nid, h)


# ---------------------------------------------------------------------------
# a mixed committee: one JAX node and two port nodes on one fabric
# ---------------------------------------------------------------------------


@pytest.fixture
def mixed(tmp_path):
    ident = tmp_path / "identity"
    jid.generate_identity("node0", ident)
    for nid in IDS[1:]:
        pid.generate_identity(nid, ident)
    peers = {n: n for n in IDS}
    fabric = LoopbackFabric()
    control = pkv.MemoryKV()
    with open(DATA / "test_preparams_1024.json") as f:
        raw_pre = json.load(f)["preparams"]
    nodes = [JaxNode("node0", IDS, fabric.transport(),
                     jid.IdentityStore(ident, "node0", peers),
                     jkv.EncryptedFileKV(tmp_path / "db0", "pw"), jki.KeyinfoStore(control),
                     JaxRegistry("node0", IDS, control, poll_interval_s=0.05),
                     preparams=JaxPreParams.from_json(raw_pre["node0"]),
                     min_paillier_bits=1020)]
    pre = load_test_preparams(1024)
    for nid in IDS[1:]:
        nodes.append(Node(nid, IDS, fabric.transport(), pid.IdentityStore(ident, nid, peers),
                          pkv.EncryptedFileKV(tmp_path / f"db-{nid}", "pw"),
                          pki.KeyinfoStore(control),
                          PeerRegistry(nid, IDS, control, poll_interval_s=0.05),
                          preparams=pre[nid], min_paillier_bits=1020, device="cpu"))
    for n in nodes:
        n.registry.ready()
    assert all(n.registry.wait_all_ready(10) for n in nodes)
    yield nodes
    for n in nodes:
        n.registry.resign()
    fabric.close()


def _run(nodes, make):
    """One session per node from ``make(node, on_done, on_error)``, run to
    the end → results by node id."""
    results, errors, done = {}, [], threading.Event()
    lock = threading.Lock()
    sessions = []

    def cb(nid):
        def on_done(res):
            with lock:
                results[nid] = res
                if len(results) == len(sessions):
                    done.set()

        def on_error(e):
            errors.append((nid, repr(e)))
            done.set()
        return on_done, on_error

    for node in nodes:
        s = make(node, *cb(node.node_id))
        if s is not None:
            sessions.append(s)
    for s in sessions:
        s.listen()
    try:
        assert done.wait(120) and not errors, errors
    finally:
        for s in sessions:
            s.close()
    return results


def test_a_jax_node_and_two_port_nodes_run_eddsa_keygen_sign_reshare(mixed):
    shares = _run(mixed, lambda n, d, e: n.create_keygen_session(
        "ed25519", "mixed-w", 1, on_done=d, on_error=e))
    pub = shares["node0"].public_key
    assert all(s.public_key == pub for s in shares.values())

    def sign(tx):
        sigs = _run(mixed, lambda n, d, e: n.create_signing_session(
            "ed25519", "mixed-w", f"tx-{tx.hex()[:8]}", tx, on_done=d, on_error=e))
        assert len(set(sigs.values())) == 1 and len(sigs) == 3
        assert hm.ed25519_verify(pub, tx, sigs["node1"])

    sign(b"mixed committee tx one")
    new = _run(mixed, lambda n, d, e: n.create_resharing_session(
        "ed25519", "mixed-w", 1, on_done=d, on_error=e))
    assert all(s.public_key == pub and s.epoch == 1 for s in new.values())
    for n in mixed:
        assert n.load_share("ed25519", "mixed-w").epoch == 1
    sign(b"mixed committee tx two")
