"""Zero-knowledge proofs of the GG18 keygen material (host python ints).

The port's copy of the two proofs of ``mpcium_tpu/protocol/ecdsa/zk.py``
that the batched DKG and reshare parties exchange once per batch:

- :class:`DLNProof` — Girault-style proof of knowledge of x with
  h2 = h1^x (mod NTilde), 128 binary-challenge iterations; certifies a
  node's ring-Pedersen parameters.
- :class:`PaillierProof` — proof that N is a valid Paillier modulus
  (gcd(N, φ(N)) = 1): y_i = x_i^{N⁻¹ mod φ} for hash-derived x_i.

Fiat–Shamir: SHA-256 over domain-tagged length-prefixed encodings, the
JAX package's bytes, so a proof made by either package verifies in the
other. ``bind`` (``"{session}:{sender}"``) ties a proof to its session
and prover. The other proofs of the module come with the per-session
protocols.
"""
from __future__ import annotations

import hashlib
import math
import secrets
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ...core.paillier import PaillierPublicKey

DLN_ITERS = 128
PAILLIER_ITERS = 13


def _hash_ints(tag: bytes, *vals: int) -> bytes:
    h = hashlib.sha256()
    h.update(b"mpcium-tpu/zk/" + tag)  # wire constant
    for v in vals:
        b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        h.update(len(b).to_bytes(4, "big"))
        h.update(b)
    return h.digest()


def _hash_to_int(tag: bytes, *vals: int) -> int:
    return int.from_bytes(_hash_ints(tag, *vals), "big")


@dataclass(frozen=True)
class DLNProof:
    alphas: Tuple[int, ...]  # DLN_ITERS commitments h1^{a_i}
    ts: Tuple[int, ...]  # responses a_i + c_i·x mod pq

    @classmethod
    def prove(cls, h1: int, h2: int, x: int, pq: int, NTilde: int, rng=secrets,
              bind: bytes = b"") -> "DLNProof":
        a = [rng.randbelow(pq) for _ in range(DLN_ITERS)]
        alphas = [pow(h1, ai, NTilde) for ai in a]
        cbits = _challenge_bits(h1, h2, NTilde, alphas, bind)
        ts = [(ai + (x if c else 0)) % pq for ai, c in zip(a, cbits)]
        return cls(alphas=tuple(alphas), ts=tuple(ts))

    def verify(self, h1: int, h2: int, NTilde: int, bind: bytes = b"") -> bool:
        if len(self.alphas) != DLN_ITERS or len(self.ts) != DLN_ITERS:
            return False
        if not (1 < h1 < NTilde and 1 < h2 < NTilde and h1 != h2):
            return False
        cbits = _challenge_bits(h1, h2, NTilde, list(self.alphas), bind)
        for ai, ti, c in zip(self.alphas, self.ts, cbits):
            if not 0 < ai < NTilde or ti < 0:
                return False
            if pow(h1, ti, NTilde) != ai * (h2 if c else 1) % NTilde:
                return False
        return True

    def to_json(self) -> dict:
        return {"alphas": [str(a) for a in self.alphas], "ts": [str(t) for t in self.ts]}

    @classmethod
    def from_json(cls, d: dict) -> "DLNProof":
        return cls(alphas=tuple(int(a) for a in d["alphas"]),
                   ts=tuple(int(t) for t in d["ts"]))


def _challenge_bits(h1: int, h2: int, NTilde: int, alphas: Sequence[int],
                    bind: bytes = b"") -> List[int]:
    """DLN_ITERS challenge bits, LSB-first per byte of SHA-256(digest ‖ ctr)."""
    digest = hashlib.sha256(_hash_ints(b"dln", h1, h2, NTilde, *alphas) + bind).digest()
    out: List[int] = []
    counter = 0
    while len(out) < DLN_ITERS:
        blk = hashlib.sha256(digest + counter.to_bytes(4, "big")).digest()
        out.extend((byte >> i) & 1 for byte in blk for i in range(8))
        counter += 1
    return out[:DLN_ITERS]


@dataclass(frozen=True)
class PaillierProof:
    ys: Tuple[int, ...]

    @classmethod
    def prove(cls, sk, bind: bytes = b"") -> "PaillierProof":
        """``sk``: PaillierPrivateKey. N-th roots of the hash-derived
        challenges prove gcd(N, φ(N)) = 1."""
        N = sk.N
        inv = pow(N, -1, (sk.p - 1) * (sk.q - 1))
        return cls(ys=tuple(pow(x, inv, N) for x in _paillier_challenges(N, bind)))

    def verify(self, pk: PaillierPublicKey, bind: bytes = b"") -> bool:
        if len(self.ys) != PAILLIER_ITERS:
            return False
        N = pk.N
        if N <= 0 or N.bit_length() < 2046:
            return False
        # reject even N and tiny factors cheaply
        if any(N % p == 0 for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)):
            return False
        for x, y in zip(_paillier_challenges(N, bind), self.ys):
            if not 0 < y < N or pow(y, N, N) != x % N:
                return False
        return True

    def to_json(self) -> dict:
        return {"ys": [str(y) for y in self.ys]}

    @classmethod
    def from_json(cls, d: dict) -> "PaillierProof":
        return cls(ys=tuple(int(y) for y in d["ys"]))


def _paillier_challenges(N: int, bind: bytes) -> List[int]:
    """PAILLIER_ITERS units of Z_N from H(N, bind, i); non-units are
    skipped (a gcd > 1 would itself reveal a factor)."""
    out: List[int] = []
    b = int.from_bytes(bind, "big") if bind else 0
    i = 0
    while len(out) < PAILLIER_ITERS:
        v = _hash_to_int(b"paillier", N, b, i) % N
        i += 1
        if v > 1 and math.gcd(v, N) == 1:
            out.append(v)
    return out
