"""Zero-knowledge proofs of GG18 (host python ints).

The port's copy of ``mpcium_tpu/protocol/ecdsa/zk.py``:

- :class:`DLNProof` — Girault-style proof of knowledge of x with
  h2 = h1^x (mod NTilde), 128 binary-challenge iterations; certifies a
  node's ring-Pedersen parameters.
- :class:`PaillierProof` — proof that N is a valid Paillier modulus
  (gcd(N, φ(N)) = 1): y_i = x_i^{N⁻¹ mod φ} for hash-derived x_i.
- :class:`SchnorrProof` — PoK of a secp256k1 discrete log (the signing
  party's Γ decommit).
- :class:`PedersenPoK` — PoK of (a, b) with V = a·R + b·G (phase 5B).
- :class:`RangeProofAlice` — the MtA initiator's proof that c = Enc(m)
  has m ∈ (-q³, q³) (GG18 appendix A.1).
- :class:`RespProofBob` — the MtA responder's proof (A.2), optionally
  binding b to X = b·G (A.3, "with check").

Fiat–Shamir: SHA-256 over domain-tagged length-prefixed encodings, the
JAX package's bytes, so a proof made by either package verifies in the
other. ``bind`` (``"{session}:{sender}"``) ties a proof to its session
and prover.
"""
from __future__ import annotations

import hashlib
import math
import secrets
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ...core import hostmath as hm
from ...core.paillier import PaillierPublicKey

Q = hm.SECP_N  # curve order

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


@dataclass(frozen=True)
class SchnorrProof:
    e: int  # challenge
    s: int  # response

    @classmethod
    def prove(cls, x: int, X: hm.SecpPoint, rng=secrets, bind: bytes = b"") -> "SchnorrProof":
        k = rng.randbelow(Q - 1) + 1
        R = hm.secp_mul(k, hm.SECP_G)
        e = _schnorr_challenge(R, X, bind)
        return cls(e=e, s=(k - e * x) % Q)

    def verify(self, X: hm.SecpPoint, bind: bytes = b"") -> bool:
        if X.is_infinity or not (0 <= self.e < Q and 0 <= self.s < Q):
            return False
        R = hm.secp_add(hm.secp_mul(self.s, hm.SECP_G), hm.secp_mul(self.e, X))
        if R.is_infinity:
            return False
        return _schnorr_challenge(R, X, bind) == self.e

    def to_json(self) -> dict:
        return {"e": str(self.e), "s": str(self.s)}

    @classmethod
    def from_json(cls, d: dict) -> "SchnorrProof":
        return cls(e=int(d["e"]), s=int(d["s"]))


def _schnorr_challenge(R: hm.SecpPoint, X: hm.SecpPoint, bind: bytes) -> int:
    h = hashlib.sha256()
    h.update(b"mpcium-tpu/zk/schnorr")  # wire constant
    h.update(hm.secp_compress(R))
    h.update(hm.secp_compress(X))
    h.update(bind)
    return int.from_bytes(h.digest(), "big") % Q


@dataclass(frozen=True)
class PedersenPoK:
    """PoK of (a, b) with V = a·R + b·G (two-generator Schnorr): the
    GG18 phase-5B consistency proof for V_i = s_i·R + l_i·G."""

    e: int
    s_a: int
    s_b: int

    @classmethod
    def prove(cls, a: int, b: int, R: hm.SecpPoint, V: hm.SecpPoint, rng=secrets,
              bind: bytes = b"") -> "PedersenPoK":
        ka = rng.randbelow(Q - 1) + 1
        kb = rng.randbelow(Q - 1) + 1
        A = hm.secp_add(hm.secp_mul(ka, R), hm.secp_mul(kb, hm.SECP_G))
        e = _pedersen_challenge(A, R, V, bind)
        return cls(e=e, s_a=(ka - e * a) % Q, s_b=(kb - e * b) % Q)

    def verify(self, R: hm.SecpPoint, V: hm.SecpPoint, bind: bytes = b"") -> bool:
        if R.is_infinity or V.is_infinity:
            return False
        if not (0 <= self.e < Q and 0 <= self.s_a < Q and 0 <= self.s_b < Q):
            return False
        A = hm.secp_add(
            hm.secp_add(hm.secp_mul(self.s_a, R), hm.secp_mul(self.s_b, hm.SECP_G)),
            hm.secp_mul(self.e, V),
        )
        if A.is_infinity:
            return False
        return _pedersen_challenge(A, R, V, bind) == self.e

    def to_json(self) -> dict:
        return {"e": str(self.e), "s_a": str(self.s_a), "s_b": str(self.s_b)}

    @classmethod
    def from_json(cls, d: dict) -> "PedersenPoK":
        return cls(e=int(d["e"]), s_a=int(d["s_a"]), s_b=int(d["s_b"]))


def _pedersen_challenge(A: hm.SecpPoint, R: hm.SecpPoint, V: hm.SecpPoint,
                        bind: bytes) -> int:
    h = hashlib.sha256()
    h.update(b"mpcium-tpu/zk/pedersen-pok")  # wire constant
    for pt in (A, R, V):
        h.update(hm.secp_compress(pt))
    h.update(bind)
    return int.from_bytes(h.digest(), "big") % Q


# ---------------------------------------------------------------------------
# MtA range proofs (GG18 appendix A)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RangeProofAlice:
    """Proof that c = Enc_N(m, r) with m ∈ (-q³, q³) (GG18 A.1). The
    ring-Pedersen parameters (NTilde, h1, h2) are the verifier's (Bob's)."""

    z: int
    u: int
    w: int
    s: int
    s1: int
    s2: int

    @classmethod
    def prove(cls, pk: PaillierPublicKey, ntilde: int, h1: int, h2: int, c: int, m: int,
              r: int, rng=secrets) -> "RangeProofAlice":
        q3 = Q**3
        N = pk.N
        alpha = rng.randbelow(q3)
        beta = _rand_unit(N, rng)
        gamma = rng.randbelow(q3 * ntilde)
        rho = rng.randbelow(Q * ntilde)

        z = pow(h1, m, ntilde) * pow(h2, rho, ntilde) % ntilde
        u = (1 + alpha * N) % pk.N2 * pow(beta, N, pk.N2) % pk.N2
        w = pow(h1, alpha, ntilde) * pow(h2, gamma, ntilde) % ntilde
        e = _range_challenge(b"alice", N, ntilde, h1, h2, c, z, u, w)
        s = pow(r, e, N) * beta % N
        s1 = e * m + alpha
        s2 = e * rho + gamma
        return cls(z=z, u=u, w=w, s=s, s1=s1, s2=s2)

    def verify(self, pk: PaillierPublicKey, ntilde: int, h1: int, h2: int, c: int) -> bool:
        q3 = Q**3
        N = pk.N
        # BOTH bounds: a negative s1 would make pow() take modular inverses
        # and the equations hold for plaintexts out of range (m ≡ -q⁶)
        if not 0 <= self.s1 <= q3:
            return False
        if self.s2 < 0:
            return False
        if not (0 < self.z < ntilde and 0 < self.u < pk.N2 and 0 < self.w < ntilde):
            return False
        if not (0 < self.s < N):
            return False
        e = _range_challenge(b"alice", N, ntilde, h1, h2, c, self.z, self.u, self.w)
        # u ?= (1+N)^{s1} s^N c^{-e} mod N²
        lhs = (1 + self.s1 * N) % pk.N2 * pow(self.s, N, pk.N2) % pk.N2
        rhs = self.u * pow(c, e, pk.N2) % pk.N2
        if lhs != rhs:
            return False
        # h1^{s1} h2^{s2} ?= w · z^e mod NTilde
        lhs2 = pow(h1, self.s1, ntilde) * pow(h2, self.s2, ntilde) % ntilde
        rhs2 = self.w * pow(self.z, e, ntilde) % ntilde
        return lhs2 == rhs2

    def to_json(self) -> dict:
        return {k: str(getattr(self, k)) for k in ("z", "u", "w", "s", "s1", "s2")}

    @classmethod
    def from_json(cls, d: dict) -> "RangeProofAlice":
        return cls(**{k: int(d[k]) for k in ("z", "u", "w", "s", "s1", "s2")})


_BOB_FIELDS = ("z", "z_prime", "t", "v", "w", "s", "s1", "s2", "t1", "t2")


@dataclass(frozen=True)
class RespProofBob:
    """Bob's MtA response proof (GG18 A.2): c2 = c1^b · Enc(β′) with
    b ∈ (-q³, q³), β′ ∈ Z_N. ``u_point`` (with check, A.3) binds X = b·G."""

    z: int
    z_prime: int
    t: int
    v: int
    w: int
    s: int
    s1: int
    s2: int
    t1: int
    t2: int
    u_point: Optional[hm.SecpPoint] = None  # None for the plain MtA

    @classmethod
    def prove(cls, pk: PaillierPublicKey, ntilde: int, h1: int, h2: int, c1: int, c2: int,
              b: int, beta_prime: int, r: int, X: Optional[hm.SecpPoint] = None,
              rng=secrets) -> "RespProofBob":
        q3 = Q**3
        q7 = Q**7
        N = pk.N
        alpha = rng.randbelow(q3)
        rho = rng.randbelow(Q * ntilde)
        rho_prime = rng.randbelow(q3 * ntilde)
        sigma = rng.randbelow(Q * ntilde)
        tau = rng.randbelow(q3 * ntilde)
        beta = _rand_unit(N, rng)
        gamma = rng.randbelow(q7)

        z = pow(h1, b, ntilde) * pow(h2, rho, ntilde) % ntilde
        z_prime = pow(h1, alpha, ntilde) * pow(h2, rho_prime, ntilde) % ntilde
        t = pow(h1, beta_prime, ntilde) * pow(h2, sigma, ntilde) % ntilde
        v = pow(c1, alpha, pk.N2) * ((1 + gamma * N) % pk.N2) * pow(beta, N, pk.N2) % pk.N2
        w = pow(h1, gamma, ntilde) * pow(h2, tau, ntilde) % ntilde
        u_point = None
        extra: Tuple[int, ...] = ()
        if X is not None:
            u_point = hm.secp_mul(alpha, hm.SECP_G)
            extra = (u_point.x, u_point.y, X.x, X.y)
        e = _range_challenge(b"bob", N, ntilde, h1, h2, c1, c2, z, z_prime, t, v, w, *extra)
        s = pow(r, e, N) * beta % N
        s1 = e * b + alpha
        s2 = e * rho + rho_prime
        t1 = e * beta_prime + gamma
        t2 = e * sigma + tau
        return cls(z=z, z_prime=z_prime, t=t, v=v, w=w, s=s, s1=s1, s2=s2, t1=t1, t2=t2,
                   u_point=u_point)

    def verify(self, pk: PaillierPublicKey, ntilde: int, h1: int, h2: int, c1: int, c2: int,
               X: Optional[hm.SecpPoint] = None) -> bool:
        q3 = Q**3
        q7 = Q**7
        N = pk.N
        # BOTH bounds (a negative value flips pow() into inverses); t1 ≤ q⁷
        # bounds Bob's β′, or a β′ near N turns Alice's decryption wrap
        # into an oracle on k_i
        if not 0 <= self.s1 <= q3:
            return False
        if not 0 <= self.t1 <= q7:
            return False
        if self.s2 < 0 or self.t2 < 0:
            return False
        if not all(0 < v_ < ntilde for v_ in (self.z, self.z_prime, self.t, self.w)):
            return False
        if not (0 < self.v < pk.N2 and 0 < self.s < N):
            return False
        extra: Tuple[int, ...] = ()
        if X is not None:
            if self.u_point is None or self.u_point.is_infinity or X.is_infinity:
                return False
            extra = (self.u_point.x, self.u_point.y, X.x, X.y)
        elif self.u_point is not None:
            return False
        e = _range_challenge(b"bob", N, ntilde, h1, h2, c1, c2, self.z, self.z_prime,
                             self.t, self.v, self.w, *extra)
        if X is not None:
            # s1·G ?= U + e·X  (binds b to the public point)
            if hm.secp_mul(self.s1, hm.SECP_G) != hm.secp_add(self.u_point,
                                                               hm.secp_mul(e, X)):
                return False
        # h1^{s1} h2^{s2} ?= z′ · z^e
        if (pow(h1, self.s1, ntilde) * pow(h2, self.s2, ntilde) % ntilde
                != self.z_prime * pow(self.z, e, ntilde) % ntilde):
            return False
        # h1^{t1} h2^{t2} ?= w · t^e
        if (pow(h1, self.t1, ntilde) * pow(h2, self.t2, ntilde) % ntilde
                != self.w * pow(self.t, e, ntilde) % ntilde):
            return False
        # c1^{s1} (1+N)^{t1} s^N ?= v · c2^e mod N²
        lhs = (pow(c1, self.s1, pk.N2) * ((1 + self.t1 * N) % pk.N2)
               * pow(self.s, N, pk.N2) % pk.N2)
        return lhs == self.v * pow(c2, e, pk.N2) % pk.N2

    def to_json(self) -> dict:
        d = {k: str(getattr(self, k)) for k in _BOB_FIELDS}
        if self.u_point is not None:
            d["u_point"] = hm.secp_compress(self.u_point).hex()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "RespProofBob":
        u = d.get("u_point")
        return cls(**{k: int(d[k]) for k in _BOB_FIELDS},
                   u_point=hm.secp_decompress(bytes.fromhex(u)) if u else None)


def _range_challenge(tag: bytes, *vals: int) -> int:
    return _hash_to_int(b"range/" + tag, *vals) % Q


def _rand_unit(N: int, rng=secrets) -> int:
    """A unit of Z_N above 1; the number of draws depends on the values."""
    while True:
        v = rng.randbelow(N)
        if v > 1 and math.gcd(v, N) == 1:
            return v
