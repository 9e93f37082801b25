#!/usr/bin/env python3
"""Host verification of signatures: serial against chip_smoke.py's pool.

    python3 scripts/torch_verify_ab.py [--ecdsa 1024] [--ed25519 4096] [--seed 1]

Makes the given numbers of secp256k1 ECDSA and Ed25519 signatures with
the port's python-int host math (set-up, spread over the pool, not
timed), then verifies every one twice with the verifiers chip_smoke.py
uses: serially in this process, as chip_smoke.py verified before it had
a pool, and over its pool of one worker process per host core. Prints
one JSON line with the seconds and the verified count of each, and the
number of workers. Needs no GPU and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _ecdsa_signed(rows):
    """(secret, nonce, digest) rows → (compressed key, digest, r, s) rows."""
    from mpcium_tpu_torch.core import hostmath as hm

    out = []
    for x, k, d in rows:
        r = hm.secp_mul(k, hm.SECP_G).x % hm.SECP_N
        s = pow(k, -1, hm.SECP_N) * (int.from_bytes(d, "big") + r * x) % hm.SECP_N
        out.append((hm.secp_compress(hm.secp_mul(x, hm.SECP_G)), d, r.to_bytes(32, "big"),
                    min(s, hm.SECP_N - s).to_bytes(32, "big")))
    return out


def _ed25519_signed(rows):
    """(seed, message) rows → (public key, message, signature) rows."""
    from mpcium_tpu_torch.core import hostmath as hm

    return [(hm.ed25519_public_from_seed(seed), msg, hm.ed25519_sign_plain(seed, msg))
            for seed, msg in rows]


def _made(fn, rows):
    chunks = [rows[i:i + 32] for i in range(0, len(rows), 32)]
    return [row for chunk in cs.host_pool().map(fn, chunks) for row in chunk]


def _timed(fn, *args):
    t0 = time.perf_counter()
    n = fn(*args)
    return time.perf_counter() - t0, n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ecdsa", type=int, default=1024)
    ap.add_argument("--ed25519", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    from mpcium_tpu_torch.core import hostmath as hm

    rng = random.Random(args.seed)
    ecdsa = _made(_ecdsa_signed, [(rng.randrange(1, hm.SECP_N), rng.randrange(1, hm.SECP_N),
                                   rng.randbytes(32)) for _ in range(args.ecdsa)])
    ed = _made(_ed25519_signed, [(rng.randbytes(32), rng.randbytes(32))
                                 for _ in range(args.ed25519)])
    serial_ecdsa = _timed(cs._ecdsa_rows, ecdsa)
    pool_ecdsa = _timed(cs.verify_ecdsa, *zip(*ecdsa))
    serial_ed = _timed(cs._ed25519_rows, ed)
    pool_ed = _timed(cs.verify_ed25519, *zip(*ed))
    cs.emit({"phase": "verify_ab", "workers": os.cpu_count(),
             "ecdsa": {"B": args.ecdsa, "serial_s": serial_ecdsa[0], "pool_s": pool_ecdsa[0],
                       "verified": [serial_ecdsa[1], pool_ecdsa[1]]},
             "ed25519": {"B": args.ed25519, "serial_s": serial_ed[0], "pool_s": pool_ed[0],
                         "verified": [serial_ed[1], pool_ed[1]]}})
    return 0 if (serial_ecdsa[1] == pool_ecdsa[1] == args.ecdsa
                 and serial_ed[1] == pool_ed[1] == args.ed25519) else 1


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if cs._POOL is not None:
            cs._POOL.shutdown()
    sys.exit(rc)
