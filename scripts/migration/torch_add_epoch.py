#!/usr/bin/env python3
"""One-off data migration of a port node's stores: backfill the reshare
``epoch`` field.

The port of ``scripts/migration/add_epoch.py``, over the port's
``store/kvstore.EncryptedFileKV`` (the node's share store) and
``FileKV`` (the control KV). Records written before epoch fencing lack
the field; readers default it to 0, and this writes the 0 explicitly,
so every node of a mixed fleet serializes the same records.

Usage:
    python scripts/migration/torch_add_epoch.py --db ./db/node0 \\
        --control ./control --password <badger_password>

Idempotent: records that already carry ``epoch`` are left untouched. It
reads and writes files only and touches no device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _backfill(kv, prefixes) -> int:
    n = 0
    for key in kv.keys():
        if not key.startswith(prefixes):
            continue
        rec = json.loads(kv.get(key))
        if "epoch" not in rec:
            rec["epoch"] = 0
            kv.put(key, json.dumps(rec).encode())
            n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--db", required=True, help="node share-store directory")
    ap.add_argument("--control", required=True, help="control-KV (FileKV) root")
    ap.add_argument("--password", required=True, help="share-store password")
    args = ap.parse_args(argv)

    from mpcium_tpu_torch.store.kvstore import EncryptedFileKV, FileKV

    migrated = _backfill(EncryptedFileKV(args.db, args.password), ("ecdsa:", "eddsa:"))
    migrated += _backfill(FileKV(args.control), ("threshold_keyinfo/",))
    print(f"backfilled epoch=0 on {migrated} records")
    return 0


if __name__ == "__main__":
    sys.exit(main())
