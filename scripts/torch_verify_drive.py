#!/usr/bin/env python3
"""Verify drive of the port: batched DKG -> batched signing (both curves)
-> reshare -> signatures checked by OpenSSL, over the port's public
surface, plus an AEAD-encrypted broker round trip.

The port of ``scripts/verify_drive.py``: the same four stages on a
3-node ``LocalCluster`` (t=1, batched, the 1024-bit fixture with the
GG18 domains it can carry):

1. ``dkg``: two wallets created in one batch; every node then holds
   both curves' shares of both;
2. ``sign``: four transactions, two on each curve, each signature
   verified by OpenSSL through ``cryptography`` (the GG18 signs run the
   Paillier MtA, so K0 on the GPU);
3. ``reshare``: both wallets' ed25519 keys rotated to t=2 (epoch 1),
   then one more sign, verified;
4. ``aead``: a publish/subscribe round trip over
   ``transport/tcp.BrokerServer(encrypt=True)``.

Each stage prints one JSON line with its wall and K0's counters over the
stage (``ops/mulmod.counters``: ``launches``, ``launches_by_width``,
``powmod_launches_by_mode_width``, ``plain_calls``); the last line is
``VERIFY-DRIVE: ALL OK``. Exit 0 when every stage passed, 1 otherwise.

    python scripts/torch_verify_drive.py                # on the GPU
    python scripts/torch_verify_drive.py --device cpu   # the plain path

Without a GPU and without ``--device cpu`` it raises before any work.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import secrets
import signal
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WALLETS = ("vw0", "vw1")
CURVES = ("ed25519", "secp256k1")


def verify_ed25519(pub_hex: str, msg: bytes, sig_hex: str) -> None:
    """OpenSSL's Ed25519 verify; raises ``InvalidSignature``."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

    Ed25519PublicKey.from_public_bytes(bytes.fromhex(pub_hex)).verify(
        bytes.fromhex(sig_hex), msg)


def verify_ecdsa(pub_hex: str, digest: bytes, r_hex: str, s_hex: str) -> None:
    """OpenSSL's secp256k1 ECDSA verify of a 32-byte digest under a
    compressed key; raises ``InvalidSignature`` (or ``ValueError`` for a
    key that is not on the curve)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec, utils

    key = ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256K1(), bytes.fromhex(pub_hex))
    key.verify(utils.encode_dss_signature(int(r_hex, 16), int(s_hex, 16)), digest,
               ec.ECDSA(utils.Prehashed(hashes.SHA256())))


def _require(ok: bool, what) -> None:
    """A verdict of the drive (not an ``assert``: it must hold under -O)."""
    if not ok:
        raise AssertionError(what)


def _collect(subscribe, fire, key, n: int, timeout_s: float, what: str) -> dict:
    """Subscribe, fire the requests, and wait for ``n`` results (by key)."""
    got: dict = {}
    done = threading.Event()

    def on_ev(ev):
        got[key(ev)] = ev
        if len(got) == n:
            done.set()

    sub = subscribe(on_ev)
    try:
        fire()
        if not done.wait(timeout_s):
            raise AssertionError(f"{what} incomplete: {sorted(got)}")
    finally:
        sub.unsubscribe()
    return got


def stage_dkg(cluster, created: dict) -> dict:
    """Fills ``created`` (wallet id -> keygen event); returns the line."""
    from mpcium_tpu_torch import wire
    from mpcium_tpu_torch.protocol.base import ProtocolError

    client = cluster.client
    created.update(_collect(client.on_wallet_creation_result,
                            lambda: [client.create_wallet(w) for w in WALLETS],
                            lambda ev: ev.wallet_id, len(WALLETS), 900, "keygen"))
    for ev in created.values():
        _require(ev.result_type == wire.RESULT_SUCCESS, ev.error_reason)
    batches = sum(ec.scheduler.batches_run for ec in cluster.consumers)
    # the first success event can precede a peer's stored share
    deadline = time.time() + 1200
    while True:
        try:
            for node in cluster.nodes.values():
                for wid in WALLETS:
                    for kt in CURVES:
                        node.load_share(kt, wid)
            break
        except ProtocolError:  # a share not stored yet
            if time.time() > deadline:
                raise AssertionError("shares did not persist cluster-wide")
            time.sleep(2)
    return {"wallets": len(created), "batches_run": batches,
            "nodes_with_all_shares": len(cluster.nodes)}


def stage_sign(cluster, created: dict) -> dict:
    from mpcium_tpu_torch import wire

    client = cluster.client
    txs = {}
    for i, wid in enumerate(WALLETS):
        for kt in CURVES:
            txs[f"vtx-{kt}-{i}"] = (wid, kt, secrets.token_bytes(32))

    def fire():
        for tid, (wid, kt, tx) in txs.items():
            client.sign_transaction(wire.SignTxMessage(
                key_type=kt, wallet_id=wid, network_internal_code="x", tx_id=tid, tx=tx))

    results = _collect(client.on_sign_result, fire, lambda ev: ev.tx_id, len(txs), 1800,
                       "signing")
    for tid, ev in results.items():
        wid, kt, tx = txs[tid]
        _require(ev.result_type == wire.RESULT_SUCCESS, f"{tid}: {ev.error_reason}")
        if kt == "ed25519":
            verify_ed25519(created[wid].eddsa_pub_key, tx, ev.signature)
        else:
            verify_ecdsa(created[wid].ecdsa_pub_key, tx, ev.r, ev.s)
    return {"signatures": len(results), "verified_openssl": len(results),
            "by_curve": {kt: sum(1 for _w, k, _t in txs.values() if k == kt) for kt in CURVES}}


def stage_reshare(cluster, created: dict) -> dict:
    from mpcium_tpu_torch import wire

    client = cluster.client
    rres = _collect(client.on_resharing_result,
                    lambda: [client.resharing(w, 2, "ed25519") for w in WALLETS],
                    lambda ev: (ev.wallet_id, ev.key_type), len(WALLETS), 900, "reshare")
    for k, ev in rres.items():
        _require(ev.result_type == wire.RESULT_SUCCESS, f"{k}: {ev.error_reason}")
    share = cluster.nodes["node0"].load_share("ed25519", WALLETS[0])
    _require(share.epoch == 1 and share.threshold == 2, (share.epoch, share.threshold))
    tx = b"\x07" * 32
    ev = cluster.sign_sync(wire.SignTxMessage(
        key_type="ed25519", wallet_id=WALLETS[0], network_internal_code="x",
        tx_id="vtx-post-reshare", tx=tx), timeout_s=900)
    _require(ev.result_type == wire.RESULT_SUCCESS, ev.error_reason)
    verify_ed25519(created[WALLETS[0]].eddsa_pub_key, tx, ev.signature)
    return {"reshared": len(rres), "epoch": share.epoch, "threshold": share.threshold,
            "post_rotation_verified": True}


def stage_aead() -> dict:
    from mpcium_tpu_torch.transport.tcp import BrokerServer, tcp_transport

    b = BrokerServer(port=0, auth_token="verify-token", encrypt=True)
    ts = []
    try:
        ts = [tcp_transport(b.host, b.port, auth_token="verify-token", encrypt=True)
              for _ in range(2)]
        got = []
        evt = threading.Event()
        ts[1].pubsub.subscribe("v.enc", lambda d: (got.append(d), evt.set()))
        time.sleep(0.2)
        ts[0].pubsub.publish("v.enc", b"over-the-wire")
        _require(evt.wait(5) and got == [b"over-the-wire"], got)
    finally:
        for t in ts:
            t.client.close()
        b.close()
    return {"roundtrip": True, "encrypt": True}


def _stage(name: str, fn, *args) -> None:
    """Run one stage with K0's counters zeroed just before; print its line."""
    from mpcium_tpu_torch.ops import mulmod as K

    K.reset_counters()
    t0 = time.perf_counter()
    line = fn(*args)
    print(json.dumps({"stage": name, "ok": True, "wall_s": round(time.perf_counter() - t0, 3),
                      **line, "k0": K.counters()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    from mpcium_tpu_torch.device import resolve

    dev = resolve(args.device)  # raises without a GPU unless told 'cpu'
    faulthandler.register(signal.SIGUSR1)
    from mpcium_tpu_torch.cluster import LocalCluster, load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils import log

    log.init(level="WARNING")
    stage = "cluster"
    try:
        cluster = LocalCluster(
            n_nodes=3, threshold=1, preparams=load_test_preparams(bits=1024),
            min_paillier_bits=1024, batch_signing=True, batch_window_s=0.2,
            reply_timeout_s=1800.0, device=dev,
        )
        try:
            for ec in cluster.consumers:
                ec.scheduler.gg18_dom = gb.Domains(alpha=600, beta_prime=320, gamma_bob=600)
                ec.scheduler.manifest_timeout_s = 600.0
            created: dict = {}
            stage = "dkg"
            _stage("dkg", stage_dkg, cluster, created)
            stage = "sign"
            _stage("sign", stage_sign, cluster, created)
            stage = "reshare"
            _stage("reshare", stage_reshare, cluster, created)
        finally:
            cluster.close()
        stage = "aead"
        _stage("aead", stage_aead)
    except Exception as e:  # noqa: BLE001 — the failing stage is the report
        print(json.dumps({"stage": stage, "ok": False, "error": repr(e)}), flush=True)
        return 1
    print("VERIFY-DRIVE: ALL OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
