"""Create a wallet, rotate its committee, then sign with the reshared
shares and verify the signature.

The port of ``examples/reshare.py``. Default: an in-process 3-node
cluster on the GPU (``--device cpu`` for the plain path); ``--config
config.yaml`` connects to a running broker and daemons instead.

Usage: python examples/torch/reshare.py [--config config.yaml] [--device cpu]
"""
import sys
import uuid

from _connect import connect

from mpcium_tpu_torch import wire
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.utils import log


def main() -> int:
    log.init()
    cluster, _args = connect(sys.argv[1:])
    try:
        wallet_id = f"wallet-{uuid.uuid4().hex[:8]}"
        ev = cluster.create_wallet_sync(wallet_id)
        print(f"wallet {wallet_id} created, eddsa pub {ev.eddsa_pub_key[:16]}…")

        res = cluster.reshare_sync(wallet_id, new_threshold=1, key_type="ed25519")
        print(f"reshared: pubkey unchanged = {res.pub_key == ev.eddsa_pub_key}")

        tx = b"post-rotation transfer"
        sres = cluster.sign_sync(
            wire.SignTxMessage(
                key_type="ed25519",
                wallet_id=wallet_id,
                network_internal_code="solana-devnet",
                tx_id=f"tx-{uuid.uuid4().hex[:8]}",
                tx=tx,
            )
        )
        assert sres.result_type == wire.RESULT_SUCCESS, sres.error_reason
        ok = hm.ed25519_verify(
            bytes.fromhex(ev.eddsa_pub_key), tx, bytes.fromhex(sres.signature)
        )
        print(f"post-rotation signature verified={ok}")
        return 0 if ok else 1
    finally:
        cluster.close()


if __name__ == "__main__":
    sys.exit(main())
