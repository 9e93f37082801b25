"""The port's cluster over the TCP bus on the CPU:

- ``LocalCluster(transport="tcp", batch_signing=True, device="cpu")``,
  with and without a hot-standby broker: two wallets created through the
  client in one burst (one ``kg`` batch: both curves), signed on ed25519
  in one batch, rotated on ed25519 (one ``rs`` batch: keys kept, epoch 1)
  and signed again; every signature verifies on the host, no scheduler
  falls back, sheds or declines, ``trace_snapshot`` is a Chrome document
  both packages' ``validate_chrome`` accept, and ``close()`` leaves no
  client thread.
- A mixed committee on one port broker: a JAX ``Node`` (node0) over the
  JAX package's TCP client and two port ``Node``s (node1, node2) over the
  port's run per-session EdDSA keygen, a sign, a reshare and a sign again
  over signed envelopes.
"""
from __future__ import annotations

import json
import secrets

import pytest
import torch

import torch_serving as srv
from mpcium_tpu.core.paillier import PreParams as JaxPreParams
from mpcium_tpu.identity import identity as jid
from mpcium_tpu.node.node import Node as JaxNode
from mpcium_tpu.registry.registry import PeerRegistry as JaxRegistry
from mpcium_tpu.store import keyinfo as jki
from mpcium_tpu.store import kvstore as jkv
from mpcium_tpu.trace import validate_chrome as jax_validate
from mpcium_tpu.transport import tcp as jtcp
from test_torch_cluster_session import IDS, _run
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)
from torch_tcp import tcp_threads_down  # noqa: F401  (closes every client)

from mpcium_tpu_torch import trace, wire
from mpcium_tpu_torch.cluster import DATA, LocalCluster, load_test_preparams
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.identity import identity as pid
from mpcium_tpu_torch.node.node import Node
from mpcium_tpu_torch.registry.registry import PeerRegistry
from mpcium_tpu_torch.store import keyinfo as pki
from mpcium_tpu_torch.store import kvstore as pkv
from mpcium_tpu_torch.transport import tcp as ptcp

torch.set_num_threads(1)  # tiny float64 matmuls: threads only contend


def _sign_eddsa(cluster, wallets, tag: str) -> None:
    msgs = {w: secrets.token_bytes(32) for w in wallets}
    b0 = srv.batches(cluster)
    got = srv.burst(cluster.client.on_sign_result,
                    lambda: [cluster.client.sign_transaction(wire.SignTxMessage(
                        "ed25519", w, "sol", f"{tag}-{w}", msgs[w])) for w in wallets],
                    lambda ev: ev.tx_id, len(wallets))
    srv.settle(cluster)
    for w, (_secp, ed) in wallets.items():
        ev = got[f"{tag}-{w}"]
        assert ev.result_type == wire.RESULT_SUCCESS, ev
        assert hm.ed25519_verify(ed, msgs[w], bytes.fromhex(ev.signature))
    assert set(srv.grown(cluster, b0).values()) == {1}


@pytest.mark.parametrize("standby", [False, True], ids=["broker", "broker+standby"])
def test_tcp_cluster_creates_signs_rotates_and_signs_eddsa(tmp_path, standby):
    cluster = LocalCluster(n_nodes=2, threshold=1, root_dir=str(tmp_path), transport="tcp",
                           broker_standby=standby, preparams=load_test_preparams(1024),
                           min_paillier_bits=1020, batch_signing=True, batch_window_s=2.0,
                           batch_manifest_timeout_s=600.0, batch_deadline_ms=900_000,
                           reply_timeout_s=600.0, device="cpu")
    try:
        assert cluster.broker is not None and (cluster.standby_broker is not None) == standby
        wallets = srv.create(cluster, "tcp")
        _sign_eddsa(cluster, wallets, "t1")
        b0 = srv.batches(cluster)
        rs = srv.burst(cluster.client.on_resharing_result,
                       lambda: [cluster.client.resharing(w, 1, "ed25519") for w in wallets],
                       lambda ev: ev.wallet_id, len(wallets))
        srv.settle(cluster)
        for w, ev in rs.items():
            assert ev.result_type == wire.RESULT_SUCCESS, ev
            assert bytes.fromhex(ev.pub_key) == wallets[w][1]
            assert all(n.load_share("ed25519", w).epoch == 1 for n in cluster.nodes.values())
        assert set(srv.grown(cluster, b0).values()) == {1}
        _sign_eddsa(cluster, wallets, "t2")
        srv.no_fallback(cluster)
        doc = cluster.trace_snapshot(meta={"test": "tcp"})
        assert trace.validate_chrome(doc) == jax_validate(doc) > 0
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"dispatch", "session"} <= names and any(n.startswith("round:") for n in names)
        if standby:  # the standby mirrored the primary's queue state
            assert cluster.standby_broker._rep_synced.is_set()
    finally:
        cluster.close()
    assert not trace.armed()
    assert cluster.trace_snapshot()["traceEvents"]  # buffers outlive close()


@pytest.fixture
def mixed(tmp_path):
    """node0 a JAX Node over the JAX TCP client, node1 and node2 port Nodes
    over the port's, all on one port broker (encrypted)."""
    broker = ptcp.BrokerServer(port=0, auth_token="mix", encrypt=True)
    ident = tmp_path / "identity"
    jid.generate_identity("node0", ident)
    for nid in IDS[1:]:
        pid.generate_identity(nid, ident)
    peers = {n: n for n in IDS}
    control = pkv.MemoryKV()
    with open(DATA / "test_preparams_1024.json") as f:
        raw_pre = json.load(f)["preparams"]
    transports = [jtcp.tcp_transport(broker.host, broker.port, auth_token="mix", encrypt=True)]
    transports += [ptcp.tcp_transport(broker.host, broker.port, auth_token="mix", encrypt=True)
                   for _ in IDS[1:]]
    nodes = [JaxNode("node0", IDS, transports[0], jid.IdentityStore(ident, "node0", peers),
                     jkv.EncryptedFileKV(tmp_path / "db0", "pw"), jki.KeyinfoStore(control),
                     JaxRegistry("node0", IDS, control, poll_interval_s=0.05),
                     preparams=JaxPreParams.from_json(raw_pre["node0"]),
                     min_paillier_bits=1020)]
    pre = load_test_preparams(1024)
    for nid, t in zip(IDS[1:], transports[1:]):
        nodes.append(Node(nid, IDS, t, pid.IdentityStore(ident, nid, peers),
                          pkv.EncryptedFileKV(tmp_path / f"db-{nid}", "pw"),
                          pki.KeyinfoStore(control),
                          PeerRegistry(nid, IDS, control, poll_interval_s=0.05),
                          preparams=pre[nid], min_paillier_bits=1020, device="cpu"))
    try:
        for n in nodes:
            n.registry.ready()
        assert all(n.registry.wait_all_ready(10) for n in nodes)
        yield nodes
    finally:
        for n in nodes:
            n.registry.resign()
        for t in transports:
            t.client.close()
        broker.close()


def test_a_jax_node_and_two_port_nodes_sign_eddsa_over_one_tcp_broker(mixed):
    shares = _run(mixed, lambda n, d, e: n.create_keygen_session(
        "ed25519", "tcp-mixed-w", 1, on_done=d, on_error=e))
    pub = shares["node0"].public_key
    assert all(s.public_key == pub for s in shares.values())

    def sign(tx):
        sigs = _run(mixed, lambda n, d, e: n.create_signing_session(
            "ed25519", "tcp-mixed-w", f"tx-{tx.hex()[:8]}", tx, on_done=d, on_error=e))
        assert len(set(sigs.values())) == 1 and len(sigs) == 3
        assert hm.ed25519_verify(pub, tx, sigs["node2"])

    sign(b"tcp mixed committee tx one")
    new = _run(mixed, lambda n, d, e: n.create_resharing_session(
        "ed25519", "tcp-mixed-w", 1, on_done=d, on_error=e))
    assert all(s.public_key == pub and s.epoch == 1 for s in new.values())
    sign(b"tcp mixed committee tx two")
