"""`mpcium-tpu-torch` — the node daemon entry point of the port.

Reference analogue: cmd/mpcium/main.go (`mpcium start -n node0`); the
port's copy of the JAX package's ``cli/main.py``. ``start`` takes
``--device`` (default ``cuda``: the node's batches run on the GPU, and it
exits with an error where there is none; ``cpu`` runs the plain
versions).
"""
from __future__ import annotations

import argparse
import os
import sys

from mpcium_tpu_torch import __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpcium-tpu-torch",
        description="MPC/TSS wallet node daemon (PyTorch / CUDA)",
    )
    sub = p.add_subparsers(dest="command")
    start = sub.add_parser("start", help="run an MPC node")
    start.add_argument("-n", "--name", required=True, help="node name")
    start.add_argument("--config", default="config.yaml", help="config file")
    start.add_argument(
        "--decrypt-private-key",
        action="store_true",
        help="prompt for passphrase to decrypt the node identity key",
    )
    start.add_argument("--debug", action="store_true")
    start.add_argument(
        "--device", default="cuda",
        help="torch device of the node's batches (default: cuda, the GPU; "
        "cpu runs the plain versions)",
    )
    broker = sub.add_parser(
        "broker", help="run the message broker (the nats-server analogue)"
    )
    broker.add_argument("--host", default="127.0.0.1")
    broker.add_argument("--port", type=int, default=4333)
    broker.add_argument(
        "--journal", default="",
        help="queue journal path (durable work queues; '' = in-memory)",
    )
    broker.add_argument(
        "--token", default=os.environ.get("MPCIUM_BROKER_TOKEN", ""),
        help="shared auth token, plaintext or sha256:<hex> "
        "(or MPCIUM_BROKER_TOKEN)",
    )
    broker.add_argument(
        "--follow", default="",
        help="run as a hot standby mirroring the primary at host:port "
        "(takes over when the primary dies; clients list both endpoints "
        "in broker_standbys)",
    )
    broker.add_argument(
        "--encrypt", action="store_true",
        default=os.environ.get("MPCIUM_BROKER_ENCRYPT", "").lower()
        not in ("", "0", "false", "no"),
        help="AEAD-encrypt every connection (X25519 + token-bound "
        "ChaCha20-Poly1305; or MPCIUM_BROKER_ENCRYPT=1)",
    )
    sub.add_parser("version", help="print version")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(__version__)
        return 0
    if args.command == "start":
        from mpcium_tpu_torch.node.daemon import run_node

        return run_node(
            name=args.name,
            config_path=args.config,
            decrypt_private_key=args.decrypt_private_key,
            debug=args.debug,
            # "cuda" is the default device: None, which raises without a GPU
            device=None if args.device == "cuda" else args.device,
        )
    if args.command == "broker":
        from mpcium_tpu_torch.node.daemon import run_broker

        return run_broker(host=args.host, port=args.port,
                          journal=args.journal, token=args.token,
                          encrypt=args.encrypt, follow=args.follow)
    build_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
