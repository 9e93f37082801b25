"""Hash commitments (commit–reveal) for the per-session protocols (the
port's copy of ``mpcium_tpu/protocol/commitments.py``).

commit = SHA-256(domain ‖ blind ‖ data) with a fresh 256-bit blind,
revealed in the decommit round. The domain tag is a wire constant: a
GPU node and a TPU node of one committee check each other's commitments.
"""
from __future__ import annotations

import hashlib
import hmac
import secrets
from typing import Sequence, Tuple

_DOMAIN = b"mpcium-tpu/commit/v1"  # wire constant


def commit(data: bytes, rng=secrets) -> Tuple[bytes, bytes]:
    """→ (commitment, blinding)."""
    blind = rng.token_bytes(32)
    return hashlib.sha256(_DOMAIN + blind + data).digest(), blind


def verify(commitment: bytes, blind: bytes, data: bytes) -> bool:
    expect = hashlib.sha256(_DOMAIN + blind + data).digest()
    return hmac.compare_digest(expect, commitment)


def encode_points(points: Sequence[bytes]) -> bytes:
    """Length-prefixed canonical concatenation of point encodings."""
    out = [len(points).to_bytes(4, "big")]
    for p in points:
        out.append(len(p).to_bytes(2, "big"))
        out.append(p)
    return b"".join(out)
