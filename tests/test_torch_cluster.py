"""The port's serving path on the CPU: ``cluster.LocalCluster`` over the
loopback fabric with the client, the event consumers and the batch
scheduler (``batch_signing=True``, ``device="cpu"``), on the 1024-bit
fixture (``min_paillier_bits`` 1020, shrunk GG18 domains); the cluster
and its checks are ``tests/torch_serving.py``'s.

- Two wallets created through the client in one burst (one ``kg`` batch:
  both curves' ``BatchedDKGParty``) and signed on both curves (one
  ``BatchedECDSASigningParty`` and one ``BatchedEDDSASigningParty`` batch
  per node), then rotated on both curves (one ``BatchedReshareParty``
  batch per curve per node: keys kept, epoch 1 in every share and
  keyinfo) and signed again with the rotated shares. One cluster and one
  pair of wallets serve both tests: a CPU GG18 batch of two takes about
  80 s (most of it K0's plain powmod), so no stage runs twice. Every
  signature verifies on the host; no scheduler falls back, sheds or
  declines a request.
- ``LocalCluster()`` without ``device=`` raises where there is no GPU,
  before it starts a thread, and ``trace_snapshot`` merges the nodes'
  flight recorders (the TCP transport, the standby broker and
  ``RemoteCluster`` are ``test_torch_cluster_tcp.py``'s and
  ``test_torch_daemon.py``'s).
- ``fault_plans`` (a node, "*" or "client"; loopback, TCP, TCP with a
  standby) wraps exactly the named transports in ``FaultyTransport``, and
  ``respawn_node`` rebuilds a killed node over its on-disk state, on
  small clusters of their own without batching.
"""
from __future__ import annotations

import threading

import pytest
import torch

import torch_serving as srv
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)

from torch_tcp import tcp_threads_down, wait_for  # noqa: F401  (closes every client)

from mpcium_tpu_torch.cluster import LocalCluster, load_test_preparams
from mpcium_tpu_torch.faults import FaultPlan, FaultyTransport, drop
from mpcium_tpu_torch.trace import validate_chrome

torch.set_num_threads(1)  # tiny float64 matmuls: threads only contend


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = srv.batched_cluster(str(tmp_path_factory.mktemp("serving")))
    yield c
    c.close()


@pytest.fixture(scope="module")
def wallets(cluster):
    return srv.create(cluster, "srv")


def test_create_and_sign_both_curves_through_the_client(cluster, wallets):
    srv.sign_both(cluster, wallets, "s1")
    srv.no_fallback(cluster)


def test_create_rotate_and_sign_both_curves_through_the_client(cluster, wallets):
    srv.reshare_both(cluster, wallets)
    srv.sign_both(cluster, wallets, "s2")
    srv.no_fallback(cluster)


def test_cluster_without_a_device_raises_before_starting_threads():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None means that GPU")
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalCluster(n_nodes=2, threshold=1)
    assert set(threading.enumerate()) <= before


def _probe_plan():
    return FaultPlan(3, [drop(p=1.0, topic="probe:*", channel="pubsub")])


@pytest.mark.parametrize("owner,kw", [("*", {}), ("node0", {"transport": "tcp"}),
                                      ("client", {"transport": "tcp", "broker_standby": True})])
def test_fault_plans_wrap_the_named_transports(tmp_path, owner, kw):
    """``fault_plans`` keyed by a node, "*" (every node, not the client)
    or "client" wraps exactly those transports, over loopback and over
    TCP with a standby broker; a wrapped transport drops what its plan
    says, passes the rest, and ``close()`` closes it."""
    c = LocalCluster(n_nodes=2, threshold=1, root_dir=str(tmp_path), device="cpu",
                     preparams=load_test_preparams(1024), fault_plans={owner: _probe_plan()},
                     **kw)
    try:
        want = {"*": ["node0", "node1"]}.get(owner, [owner])
        assert sorted(c.fault_transports) == want
        ft = c.fault_transports[want[0]]
        assert isinstance(ft, FaultyTransport) and ft.node_id == want[0]
        assert (c.client.transport is ft) == (owner == "client")
        assert all((c.nodes[n].transport is c.fault_transports.get(n)) == (n in want)
                   for n in c.node_ids)
        got = []
        bare = c._mk_transport()
        for topic in ("probe:*", "other:*"):
            bare.pubsub.subscribe(topic, got.append)

        def passes(data: bytes) -> bool:  # once the subscriptions are live
            ft.pubsub.publish("other:1", data)
            return wait_for(lambda: data in got, 0.5)

        assert wait_for(lambda: passes(b"live"), 10.0)
        ft.pubsub.publish("probe:1", b"dropped")
        assert passes(b"after")  # one connection: in order after the probe
        assert b"dropped" not in got
        assert ft.stats.to_json() == {"counters": {"drop#0": {"drop": 1}},
                                      "retries_observed": 0, "events": 1}
    finally:
        c.close()
    assert ft._timers._closed


def test_respawn_node_rebuilds_a_killed_node_over_its_disk_state(tmp_path):
    """A node killed mid-life (transport silent, heartbeat stopped) is
    rebuilt by ``respawn_node`` over its identity, share store and WAL on
    the cluster's device: a new node and consumer, the dead incarnation's
    faulty transport retired, its wallet's share read back from disk,
    and the committee signs with it again."""
    from mpcium_tpu_torch import wire
    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.faults import chaos

    c = LocalCluster(n_nodes=3, threshold=1, root_dir=str(tmp_path), device="cpu",
                     preparams=load_test_preparams(1024), fault_plans={"node2": FaultPlan(1, [])},
                     session_wal=True, hello_timeout_s=4.0, reply_timeout_s=6.0)
    try:
        chaos._eddsa_keygen(c, "w-rs")
        old_node, old_ft = c.nodes["node2"], c.fault_transports["node2"]
        share = old_node.kvstore.get("eddsa:w-rs")
        chaos.kill_node(c, "node2")
        assert old_ft.crash_switch.crashed
        ec = c.respawn_node("node2")
        node = c.nodes["node2"]
        assert node is not old_node and c.node_consumers["node2"] is ec
        assert node.device == torch.device("cpu") and ec.device == node.device
        assert c._retired_fault_transports == [old_ft]
        assert c.fault_transports["node2"] is not old_ft
        assert node.kvstore.get("eddsa:w-rs") == share is not None
        assert node.session_wal is not None and node.session_wal.incomplete() == []
        assert wait_for(lambda: c.nodes["node0"].registry.is_peer_ready("node2"), 15.0)
        ev = chaos._sign(c, "w-rs", "tx-rs0")
        assert ev.result_type == wire.RESULT_SUCCESS, ev.error_reason
        pub = bytes.fromhex(node.keyinfo.get(wire.KEY_TYPE_ED25519, "w-rs").public_key)
        assert hm.ed25519_verify(pub, b"chaos:tx-rs0", bytes.fromhex(ev.signature))
    finally:
        c.close()
    assert old_ft._timers._closed


def test_cluster_trace_and_prometheus_entry_points(cluster):
    doc = cluster.trace_snapshot()
    assert validate_chrome(doc) > 0
    assert {"node0", "node1"} <= set(doc["otherData"]["dropped_spans"])
    assert 'scheduler_fallback_total{node="node0"} 0.0' in cluster.prometheus_text()
