"""What the port's serving tests share: a two-node batched
``LocalCluster`` on the CPU (1024-bit fixture, shrunk GG18 domains),
bursts through its client, and the checks every stage makes."""
from __future__ import annotations

import secrets
import threading
import time

from mpcium_tpu_torch import wire
from mpcium_tpu_torch.cluster import LocalCluster, load_test_preparams
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.engine import gg18_batch as gb
from mpcium_tpu_torch.ops import mulmod as K

TEST_DOM = gb.Domains(alpha=600, beta_prime=320, gamma_bob=600)
W = 2


def batched_cluster(root: str) -> LocalCluster:
    """Two nodes, t=1: the scheduler signs with every ready node, and a
    third GG18 signer triples the CPU cost of a sign (the card runs
    three, in ``chip_smoke.py``'s phase ``serving``). The leader cuts its
    manifest when the window closes, by which time every node holds the
    whole burst: a manifest that overtakes a follower's intake of one of
    its requests strands that request's claim (the JAX scheduler's
    late-intake path). The timeouts outlast a CPU batch."""
    c = LocalCluster(n_nodes=2, threshold=1, root_dir=root,
                     preparams=load_test_preparams(1024), min_paillier_bits=1020,
                     batch_signing=True, batch_window_s=2.0,
                     batch_manifest_timeout_s=600.0, batch_deadline_ms=900_000,
                     reply_timeout_s=600.0, device="cpu")
    for ec in c.consumers:
        ec.scheduler.gg18_dom = TEST_DOM
    return c


def settle(cluster, limit_s: float = 60.0) -> None:
    """Until no node holds a request claim: every node persisted and
    answered (results come from the first node to finish)."""
    deadline = time.monotonic() + limit_s
    while any(ec._sessions for ec in cluster.consumers):
        assert time.monotonic() < deadline, [sorted(ec._sessions) for ec in cluster.consumers]
        time.sleep(0.05)


def burst(subscribe, fire, key, n: int):
    got, done = {}, threading.Event()

    def on(ev):
        got[key(ev)] = ev
        if len(got) >= n:
            done.set()

    sub = subscribe(on)
    try:
        fire()
        assert done.wait(600), f"{len(got)}/{n} results"
    finally:
        sub.unsubscribe()
    return got


def batches(cluster):
    return {nid: ec.scheduler.batches_run for nid, ec in cluster.node_consumers.items()}


def grown(cluster, before):
    return {nid: v - before[nid] for nid, v in batches(cluster).items()}


def create(cluster, prefix: str):
    """W wallets in one burst → one kg batch per node; their public keys."""
    ids = [f"{prefix}-{i}" for i in range(W)]
    b0 = batches(cluster)
    kg = burst(cluster.client.on_wallet_creation_result,
               lambda: [cluster.client.create_wallet(w) for w in ids],
               lambda ev: ev.wallet_id, W)
    settle(cluster)
    assert all(ev.result_type == wire.RESULT_SUCCESS for ev in kg.values()), kg
    assert set(grown(cluster, b0).values()) == {1}
    return {w: (bytes.fromhex(kg[w].ecdsa_pub_key), bytes.fromhex(kg[w].eddsa_pub_key))
            for w in ids}


def sign_both(cluster, wallets, tag: str) -> None:
    """W ECDSA + W EdDSA signs in one burst → one batch per curve per
    node; every signature verified on the host."""
    digests = {w: secrets.token_bytes(32) for w in wallets}
    b0 = batches(cluster)
    K.reset_counters()

    def fire():
        for kt in ("secp256k1", "ed25519"):
            for w in wallets:
                cluster.client.sign_transaction(
                    wire.SignTxMessage(kt, w, "net", f"{tag}-{kt}-{w}", digests[w]))

    got = burst(cluster.client.on_sign_result, fire, lambda ev: ev.tx_id, 2 * W)
    settle(cluster)
    for w, (secp, ed) in wallets.items():
        ec, edv = got[f"{tag}-secp256k1-{w}"], got[f"{tag}-ed25519-{w}"]
        assert ec.result_type == edv.result_type == wire.RESULT_SUCCESS, (ec, edv)
        assert hm.ecdsa_verify(hm.secp_decompress(secp), int.from_bytes(digests[w], "big"),
                               int(ec.r, 16), int(ec.s, 16))
        assert int(ec.signature_recovery, 16) in (0, 1, 2, 3)
        assert hm.ed25519_verify(ed, digests[w], bytes.fromhex(edv.signature))
    assert set(grown(cluster, b0).values()) == {2}
    # on the CPU the batch reached K0's plain versions, never a kernel
    assert K.plain_calls > 0 and K.launches == 0 and not K.powmod_launches_by_mode_width


def reshare_both(cluster, wallets) -> None:
    """Every wallet rotated on both curves (t=1) → one rs batch per curve
    per node; keys kept, epoch 1 in every share and keyinfo."""
    b0 = batches(cluster)
    rs = burst(cluster.client.on_resharing_result,
               lambda: [cluster.client.resharing(w, 1, kt) for kt in ("secp256k1", "ed25519")
                        for w in wallets],
               lambda ev: (ev.wallet_id, ev.key_type), 2 * W)
    settle(cluster)
    for (w, kt), ev in rs.items():
        assert ev.result_type == wire.RESULT_SUCCESS, ev
        assert bytes.fromhex(ev.pub_key) == wallets[w][0 if kt == "secp256k1" else 1]
        for node in cluster.nodes.values():
            assert node.load_share(kt, w).epoch == 1 and node.keyinfo.get(kt, w).epoch == 1
    assert set(grown(cluster, b0).values()) == {2}


def no_fallback(cluster) -> None:
    for nid, h in cluster.health().items():
        c = h["metrics"]["counters"]
        assert c["scheduler.fallback_total"] == 0, (nid, c)
        assert c["scheduler.shed_total"] == 0, (nid, c)
        assert c["scheduler.declined_total"] == 0, (nid, c)
        assert h["batch_signing"] and h["live_sessions"] == 0, (nid, h)
