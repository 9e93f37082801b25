"""Create a wallet, then sign one EdDSA and one ECDSA transaction through
the durable signing pipeline, and verify both signatures.

The port of ``examples/sign.py``. Default: an in-process 3-node cluster
on the GPU (``--device cpu`` for the plain path); ``--config
config.yaml`` connects to a running broker and daemons instead. Exit 0
only when both signatures verify.

Usage: python examples/torch/sign.py [--config config.yaml] [--device cpu]
"""
import hashlib
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
        print(f"wallet {wallet_id} created")

        # EdDSA (Solana-style)
        tx = b"transfer 1 SOL to Ghk9..."
        res = cluster.sign_sync(
            wire.SignTxMessage(
                key_type="ed25519",
                wallet_id=wallet_id,
                network_internal_code="solana-devnet",
                tx_id=f"tx-{uuid.uuid4().hex[:8]}",
                tx=tx,
            )
        )
        assert res.result_type == wire.RESULT_SUCCESS, res.error_reason
        ed_ok = hm.ed25519_verify(
            bytes.fromhex(ev.eddsa_pub_key), tx, bytes.fromhex(res.signature)
        )
        print(f"eddsa signature: {res.signature[:32]}…  verified={ed_ok}")

        # ECDSA (EVM-style, signs a 32-byte digest)
        digest = hashlib.sha256(b"eth transfer").digest()
        res = cluster.sign_sync(
            wire.SignTxMessage(
                key_type="secp256k1",
                wallet_id=wallet_id,
                network_internal_code="ethereum",
                tx_id=f"tx-{uuid.uuid4().hex[:8]}",
                tx=digest,
            )
        )
        assert res.result_type == wire.RESULT_SUCCESS, res.error_reason
        ec_ok = hm.ecdsa_verify(
            hm.secp_decompress(bytes.fromhex(ev.ecdsa_pub_key)),
            int.from_bytes(digest, "big"),
            int(res.r, 16),
            int(res.s, 16),
        )
        print(f"ecdsa signature: r={res.r[:16]}… s={res.s[:16]}… "
              f"recovery={res.signature_recovery}  verified={ec_ok}")
        return 0 if ed_ok and ec_ok else 1
    finally:
        cluster.close()


if __name__ == "__main__":
    sys.exit(main())
