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
  before it starts a thread; the parts not ported raise
  ``NotImplementedError``.
"""
from __future__ import annotations

import threading

import pytest
import torch

import torch_serving as srv
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)

from mpcium_tpu_torch.cluster import LocalCluster, RemoteCluster

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


@pytest.mark.parametrize("kw", [{"transport": "tcp"}, {"fault_plans": {"*": object()}},
                                {"broker_standby": True}])
def test_unported_cluster_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        LocalCluster(n_nodes=2, threshold=1, device="cpu", **kw)


def test_unported_cluster_entry_points_raise(cluster):
    with pytest.raises(NotImplementedError, match="item 5"):
        RemoteCluster("config.yaml")
    with pytest.raises(NotImplementedError, match="item 6"):
        cluster.respawn_node("node0")
    with pytest.raises(NotImplementedError, match="item 8"):
        cluster.trace_snapshot()
    assert 'scheduler_fallback_total{node="node0"} 0.0' in cluster.prometheus_text()
