"""`mpcium-tpu-torch-cli` — ops tooling (the port's copy of the JAX package's
``cli/ops.py``).

Reference analogue: cmd/mpcium-cli (generate-peers, register-peers,
generate-identity, generate-initiator). Subcommands are registered lazily so
the entry point works even while later layers are still landing.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpcium-tpu-torch-cli", description="mpcium-tpu-torch ops tooling"
    )
    sub = p.add_subparsers(dest="command")

    gp = sub.add_parser("generate-peers", help="generate peers.json")
    gp.add_argument("-n", "--number", type=int, required=True)
    gp.add_argument("-o", "--output", default="peers.json")

    rp = sub.add_parser(
        "register-peers", help="register peers.json into the registry"
    )
    rp.add_argument("-p", "--peers", default="peers.json")
    rp.add_argument("--registry-dir", default="registry")
    rp.add_argument(
        "--broker", default="",
        help="host:port — register into the broker control plane instead "
        "of a FileKV directory (multi-host deployments; see "
        "control_plane: broker)",
    )
    rp.add_argument("--broker-token", default="",
                    help="broker auth token (with --broker)")
    rp.add_argument("--broker-encrypt", action="store_true",
                    help="AEAD channel to the broker (with --broker)")

    gi = sub.add_parser("generate-identity", help="generate a node identity")
    gi.add_argument("--node", required=True)
    gi.add_argument("--encrypt", action="store_true")
    gi.add_argument("--identity-dir", default="identity")
    gi.add_argument("-p", "--peers", default="peers.json")

    gin = sub.add_parser(
        "generate-initiator", help="generate the event-initiator identity"
    )
    gin.add_argument("--encrypt", action="store_true")
    gin.add_argument("-o", "--output-dir", default=".")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command is None:
        build_parser().print_help()
        return 1
    from mpcium_tpu_torch.cli import commands

    return commands.dispatch(args)


if __name__ == "__main__":
    sys.exit(main())
