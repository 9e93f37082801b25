"""MtA (multiplicative-to-additive) share conversion for the per-session
GG18 signing party, host python ints (the port's copy of
``mpcium_tpu/protocol/ecdsa/mta.py``; the batched party runs the same
equations on the card through ``ops.paillier_mxu``).

Two parties holding a and b end with α + β ≡ a·b (mod q) without
revealing their inputs:

  Alice:  cA = Enc_A(a)            + RangeProofAlice (a < q³)
  Bob:    cB = cA^b · Enc_A(β′)    + RespProofBob (b < q³, β′ committed)
          β  = −β′ mod q
  Alice:  α  = Dec_A(cB) mod q     (the integer a·b + β′ < N, no wrap)

The "with check" variant (MtAwc) also binds b to the public point
B = b·G: Bob's input is then his additive key share w_j (GG18 §5).
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional, Tuple

from ...core import hostmath as hm
from ...core.paillier import PaillierPrivateKey, PaillierPublicKey
from .zk import Q, RangeProofAlice, RespProofBob, _rand_unit


@dataclass(frozen=True)
class MtaInit:
    """Alice → Bob."""

    c_a: int
    proof: RangeProofAlice

    def to_json(self) -> dict:
        return {"c_a": str(self.c_a), "proof": self.proof.to_json()}

    @classmethod
    def from_json(cls, d: dict) -> "MtaInit":
        return cls(c_a=int(d["c_a"]), proof=RangeProofAlice.from_json(d["proof"]))


@dataclass(frozen=True)
class MtaResp:
    """Bob → Alice."""

    c_b: int
    proof: RespProofBob

    def to_json(self) -> dict:
        return {"c_b": str(self.c_b), "proof": self.proof.to_json()}

    @classmethod
    def from_json(cls, d: dict) -> "MtaResp":
        return cls(c_b=int(d["c_b"]), proof=RespProofBob.from_json(d["proof"]))


def mta_init(pk_a: PaillierPublicKey, ntilde_b: int, h1_b: int, h2_b: int, a: int,
             rng=secrets) -> Tuple[MtaInit, int]:
    """Alice's first flow → (message, r_a), r_a the Paillier randomness."""
    assert 0 <= a < Q
    r = _rand_unit(pk_a.N, rng)
    c_a = pk_a.encrypt(a, r=r)
    proof = RangeProofAlice.prove(pk_a, ntilde_b, h1_b, h2_b, c_a, a, r, rng=rng)
    return MtaInit(c_a=c_a, proof=proof), r


def mta_respond(pk_a: PaillierPublicKey, ntilde_a: int, h1_a: int, h2_a: int,
                ntilde_b: int, h1_b: int, h2_b: int, init: MtaInit, b: int,
                with_check: bool = False, rng=secrets,
                init_verified: bool = False) -> Tuple[MtaResp, int]:
    """Bob's flow: verify Alice's proof (under Bob's own ring-Pedersen
    parameters), evaluate homomorphically, prove (under Alice's) →
    (message, β), β Bob's additive share. Raises ValueError when Alice's
    proof fails. ``init_verified=True`` skips the check, for the second
    response to the SAME init (the γ and w MtAs share one Enc(k))."""
    assert 0 <= b < Q
    if not init_verified:
        if not init.proof.verify(pk_a, ntilde_b, h1_b, h2_b, init.c_a):
            raise ValueError("MtA: Alice's range proof failed")
        if not 0 < init.c_a < pk_a.N2:
            raise ValueError("MtA: ciphertext out of range")
    # β′ ← Z_{q⁵} (GG18 §A.2): wide enough to mask a·b mod q, narrow enough
    # that a·b + β′ < q⁶ + q⁵ ≪ N never wraps the plaintext ring
    beta_prime = rng.randbelow(Q**5)
    r = _rand_unit(pk_a.N, rng)
    c_beta = pk_a.encrypt(beta_prime, r=r)
    c_b = pow(init.c_a, b, pk_a.N2) * c_beta % pk_a.N2
    X = hm.secp_mul(b, hm.SECP_G) if with_check else None
    proof = RespProofBob.prove(pk_a, ntilde_a, h1_a, h2_a, init.c_a, c_b, b, beta_prime, r,
                               X=X, rng=rng)
    return MtaResp(c_b=c_b, proof=proof), (-beta_prime) % Q


def mta_finalize(sk_a: PaillierPrivateKey, ntilde_a: int, h1_a: int, h2_a: int,
                 init: MtaInit, resp: MtaResp, X: Optional[hm.SecpPoint] = None) -> int:
    """Alice's last flow: verify Bob's proof (under Alice's ring-Pedersen
    parameters), decrypt → α. ``X`` turns on the with-check binding
    b·G == X. Raises ValueError when the proof fails."""
    pk_a = sk_a.public
    if not resp.proof.verify(pk_a, ntilde_a, h1_a, h2_a, init.c_a, resp.c_b, X=X):
        raise ValueError("MtA: Bob's response proof failed")
    if not 0 < resp.c_b < pk_a.N2:
        raise ValueError("MtA: response ciphertext out of range")
    return sk_a.decrypt(resp.c_b) % Q
