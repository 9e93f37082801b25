"""Paillier keys and GG18 pre-parameters (host side).

The port's own copy of the host parts of ``mpcium_tpu/core/paillier.py``
that the signing slice needs: the key types and :class:`PreParams` with
their JSON forms, so keys written by the JAX package load here unchanged.
The batched device arithmetic lives in :mod:`ops.paillier_mxu`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class PaillierPublicKey:
    N: int

    @property
    def N2(self) -> int:
        return self.N * self.N

    def to_json(self) -> dict:
        return {"N": str(self.N)}

    @classmethod
    def from_json(cls, d: dict) -> "PaillierPublicKey":
        return cls(N=int(d["N"]))


@dataclass(frozen=True)
class PaillierPrivateKey:
    p: int
    q: int

    @property
    def public(self) -> PaillierPublicKey:
        return PaillierPublicKey(self.p * self.q)

    @property
    def N(self) -> int:
        return self.p * self.q

    @functools.cached_property
    def lam(self) -> int:  # λ = lcm(p-1, q-1)
        return (self.p - 1) * (self.q - 1) // math.gcd(self.p - 1, self.q - 1)

    @functools.cached_property
    def mu(self) -> int:  # μ = (L(g^λ mod N²))⁻¹ mod N
        N = self.N
        u = pow(N + 1, self.lam, N * N)
        return pow((u - 1) // N, -1, N)

    def decrypt(self, c: int) -> int:
        """Host reference decryption (tests)."""
        N = self.N
        u = pow(c, self.lam, N * N)
        return (u - 1) // N * self.mu % N

    def to_json(self) -> dict:
        return {"p": str(self.p), "q": str(self.q)}

    @classmethod
    def from_json(cls, d: dict) -> "PaillierPrivateKey":
        return cls(p=int(d["p"]), q=int(d["q"]))


@dataclass(frozen=True)
class PreParams:
    """Per-node Paillier key + ring-Pedersen parameters (NTilde, h1, h2)
    for the MtA range proofs; ``alpha``/``beta`` are the secret dlogs
    (h2 = h1^alpha, h1 = h2^beta mod NTilde), P, Q the safe primes."""

    paillier: PaillierPrivateKey
    NTilde: int
    h1: int
    h2: int
    alpha: int
    beta: int
    P: int
    Q: int

    def to_json(self) -> dict:
        return {
            "paillier": self.paillier.to_json(),
            "NTilde": str(self.NTilde),
            "h1": str(self.h1),
            "h2": str(self.h2),
            "alpha": str(self.alpha),
            "beta": str(self.beta),
            "P": str(self.P),
            "Q": str(self.Q),
        }

    @classmethod
    def from_json(cls, d: dict) -> "PreParams":
        return cls(
            paillier=PaillierPrivateKey.from_json(d["paillier"]),
            NTilde=int(d["NTilde"]),
            h1=int(d["h1"]),
            h2=int(d["h2"]),
            alpha=int(d["alpha"]),
            beta=int(d["beta"]),
            P=int(d["P"]),
            Q=int(d["Q"]),
        )
