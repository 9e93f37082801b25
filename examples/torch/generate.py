"""Create a wallet through the port's client SDK.

The port of ``examples/generate.py``. Default: an in-process 3-node
cluster on the GPU (``--device cpu`` for the plain path). With
``--config config.yaml`` the client connects to a running broker and
daemons instead.

Usage: python examples/torch/generate.py [--config config.yaml] [--device cpu] [wallet-id]
"""
import sys
import uuid

from _connect import connect

from mpcium_tpu_torch.utils import log


def main() -> int:
    log.init()
    cluster, args = connect(sys.argv[1:])
    wallet_id = args[0] if args else f"wallet-{uuid.uuid4().hex[:8]}"
    try:
        ev = cluster.create_wallet_sync(wallet_id)
        print(f"wallet created: {ev.wallet_id}")
        print(f"  ecdsa (secp256k1) pubkey: {ev.ecdsa_pub_key}")
        print(f"  eddsa (ed25519)  pubkey: {ev.eddsa_pub_key}")
        return 0
    finally:
        cluster.close()


if __name__ == "__main__":
    sys.exit(main())
