"""Implementations of the ops CLI subcommands.

Reference behaviors mirrored (see SURVEY.md §2.1 #2):
- generate-peers  → peers.json {name: uuid}           (generate-peers.go:18-64)
- register-peers  → registry dir / peers db           (register-peers.go:16-70)
- generate-identity → <node>_identity.json + key file (generate-identity.go)
- generate-initiator → initiator keypair + metadata   (generate-initiator.go)
"""
from __future__ import annotations

import getpass
import json
import os
import platform
import uuid
from datetime import datetime, timezone


def dispatch(args) -> int:
    return {
        "generate-peers": _generate_peers,
        "register-peers": _register_peers,
        "generate-identity": _generate_identity,
        "generate-initiator": _generate_initiator,
    }[args.command](args)


def _generate_peers(args) -> int:
    peers = {f"node{i}": str(uuid.uuid4()) for i in range(args.number)}
    with open(args.output, "w") as f:
        json.dump(peers, f, indent=2)
    print(f"wrote {args.output} with {args.number} peers")
    return 0


def _register_peers(args) -> int:
    with open(args.peers) as f:
        peers = json.load(f)
    if getattr(args, "broker", ""):
        from mpcium_tpu_torch.store.broker_kv import BrokerKV
        from mpcium_tpu_torch.transport.tcp import TcpClient, parse_addrs

        host, port = parse_addrs(args.broker)[0]
        cli = TcpClient(
            host, port,
            auth_token=args.broker_token or None,
            encrypt=args.broker_encrypt,
            reconnect=False,
        )
        try:
            kv = BrokerKV(cli)
            for name, node_id in peers.items():
                kv.put(f"mpc_peers/{name}", node_id.encode())
        finally:
            cli.close()
        print(f"registered {len(peers)} peers into broker {args.broker}")
        return 0
    from mpcium_tpu_torch.store.kvstore import FileKV

    kv = FileKV(args.registry_dir)
    for name, node_id in peers.items():
        kv.put(f"mpc_peers/{name}", node_id.encode())
    print(f"registered {len(peers)} peers into {args.registry_dir}")
    return 0


def _require_password() -> str:
    """Reference password policy: ≥12 chars incl. a special char
    (generate-identity.go:53-63)."""
    pw = getpass.getpass("passphrase: ")
    if len(pw) < 12 or not any(not c.isalnum() for c in pw):
        raise SystemExit(
            "passphrase must be ≥12 chars and contain a special character"
        )
    if getpass.getpass("confirm passphrase: ") != pw:
        raise SystemExit("passphrases do not match")
    return pw


def _generate_identity(args) -> int:
    from mpcium_tpu_torch.identity.identity import generate_identity

    with open(args.peers) as f:
        peers = json.load(f)
    if args.node not in peers:
        raise SystemExit(f"node {args.node!r} not present in {args.peers}")
    password = _require_password() if args.encrypt else None
    ident = generate_identity(args.node, args.identity_dir, passphrase=password)
    print(f"wrote {args.identity_dir}/{args.node}_identity.json")
    print(
        f"wrote {args.identity_dir}/{args.node}_private.key"
        + (".enc" if password else "")
    )
    print(f"public key: {ident.public_key.hex()}")
    return 0


def _generate_initiator(args) -> int:
    from pathlib import Path

    from mpcium_tpu_torch.identity.identity import InitiatorKey

    password = _require_password() if args.encrypt else None
    key = InitiatorKey.generate()
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    key.save(out / "event_initiator.key", passphrase=password)
    meta = {
        "public_key": key.public_bytes.hex(),
        "creator": os.environ.get("USER", "unknown"),
        "host": platform.node(),
        "os": f"{platform.system()} {platform.release()}",
        "created_at": datetime.now(timezone.utc).isoformat(),
    }
    (out / "event_initiator.json").write_text(json.dumps(meta, indent=2))
    print(f"wrote {out}/event_initiator.key" + (".enc" if password else ""))
    print(f"wrote {out}/event_initiator.json")
    print(f"initiator public key: {meta['public_key']}")
    print("set event_initiator_pubkey to this value in every node's config.yaml")
    return 0
