"""Paillier keys, prime generation and GG18 pre-parameters (host side).

The port's own copy of the host parts of ``mpcium_tpu/core/paillier.py``:
Miller–Rabin and (safe-)prime search, the key types with host
encryption and homomorphic operations, the safe-prime pool file and
:class:`PreParams` with their JSON forms, so keys written by the JAX
package load here unchanged. Every random value comes from ``rng``
(``secrets`` in production) in the JAX package's order, so a seeded
stream gives the same primes and keys in both packages. The batched
device arithmetic lives in :mod:`ops.paillier_mxu`.
"""
from __future__ import annotations

import contextlib
import fcntl
import functools
import json
import math
import os
import secrets
from dataclasses import dataclass
from typing import Optional, Tuple

PAILLIER_BITS = 2048

_SMALL_PRIMES = [p for p in range(3, 1000) if all(p % d for d in range(2, p))]


def is_probable_prime(n: int, rounds: int = 30, rng=secrets) -> bool:
    """Miller–Rabin with random bases (error ≤ 4^-rounds)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n == p:
            return True
        if n % p == 0:
            return False
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = rng.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_prime(bits: int, rng=secrets) -> int:
    while True:
        c = rng.randbits(bits) | (1 << (bits - 1)) | 1
        if is_probable_prime(c, rng=rng):
            return c


def gen_safe_prime(bits: int, rng=secrets) -> int:
    """p = 2q+1 with q prime. Sieve on both p and q, then base-2 Fermat
    screens, before Miller–Rabin."""
    while True:
        q = rng.randbits(bits - 1) | (1 << (bits - 2)) | 1
        p = 2 * q + 1
        if any(q % s == 0 or p % s == 0 for s in _SMALL_PRIMES):
            continue
        if pow(2, q - 1, q) != 1:
            continue
        if pow(2, p - 1, p) != 1:
            continue
        if is_probable_prime(q, rng=rng) and is_probable_prime(p, rng=rng):
            return p


@dataclass(frozen=True)
class PaillierPublicKey:
    N: int

    @property
    def N2(self) -> int:
        return self.N * self.N

    @property
    def g(self) -> int:  # standard g = N + 1
        return self.N + 1

    def encrypt(self, m: int, r: Optional[int] = None, rng=secrets) -> int:
        assert 0 <= m < self.N
        if r is None:
            while True:
                r = rng.randbelow(self.N)
                if r and math.gcd(r, self.N) == 1:
                    break
        # (1+N)^m = 1 + mN (mod N²)
        return (1 + m * self.N) % self.N2 * pow(r, self.N, self.N2) % self.N2

    def add(self, c1: int, c2: int) -> int:
        return c1 * c2 % self.N2

    def scalar_mul(self, c: int, k: int) -> int:
        return pow(c, k, self.N2)

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
        """Host decryption (the per-session MtA; tests)."""
        N = self.N
        u = pow(c, self.lam, N * N)
        return (u - 1) // N * self.mu % N

    def to_json(self) -> dict:
        return {"p": str(self.p), "q": str(self.q)}

    @classmethod
    def from_json(cls, d: dict) -> "PaillierPrivateKey":
        return cls(p=int(d["p"]), q=int(d["q"]))


def gen_paillier_key(bits: int = PAILLIER_BITS, rng=secrets) -> PaillierPrivateKey:
    """Distinct primes p≠q with N exactly ``bits`` bits."""
    half = bits // 2
    while True:
        p = gen_prime(half, rng)
        q = gen_prime(half, rng)
        if p != q and (p * q).bit_length() == bits:
            return PaillierPrivateKey(p=min(p, q), q=max(p, q))


# ---------------------------------------------------------------------------
# safe-prime pool: a file of pre-searched safe primes makes a node's
# start instant (the search takes minutes at 1024 bits)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _pool_lock(path):
    """Exclusive flock around the pool's read-modify-write: two daemons
    sharing one pool must never take the SAME safe primes (shared NTilde
    factors let each forge the other's MtA range proofs). The lock file
    and the pool are 0600: the pool holds future secret NTilde factors."""
    fd = os.open(str(path) + ".lock", os.O_CREAT | os.O_RDWR, 0o600)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _pool_write(path, data) -> None:
    tmp = str(path) + ".tmp"
    fd = os.open(tmp, os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o600)
    with os.fdopen(fd, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


def _pool_read(path, bits: int) -> dict:
    with open(path) as f:
        data = json.load(f)
    if data.get("bits", bits) != bits:
        raise ValueError("pool bit-size mismatch")
    return data


def pool_take(path, count: int = 2, bits: int = 1024, rng=secrets) -> list:
    """Pop ``count`` safe primes from a JSON pool file ({"bits",
    "safe_primes": [str]}), generating fresh ones when the pool is short.
    The file is rewritten without the primes taken (a prime must never
    serve two NTilde moduli). A missing file: every prime is fresh."""
    primes: list = []
    if path is not None and os.path.exists(path):
        with _pool_lock(path):
            data = _pool_read(path, bits)
            avail = [int(p) for p in data.get("safe_primes", [])]
            take, rest = avail[:count], avail[count:]
            primes.extend(take)
            if take:
                data["safe_primes"] = [str(p) for p in rest]
                _pool_write(path, data)
    while len(primes) < count:
        primes.append(gen_safe_prime(bits, rng))
    return primes


def pool_fill(path, target: int, bits: int = 1024, rng=secrets) -> int:
    """Top the pool file up to ``target`` primes; returns how many were
    generated. The search runs outside the lock; each append re-takes it."""
    made = 0
    while True:
        with _pool_lock(path):
            data = {"bits": bits, "safe_primes": []}
            if os.path.exists(path):
                data = _pool_read(path, bits)
            if len(data["safe_primes"]) >= target:
                return made
        p = gen_safe_prime(bits, rng)
        with _pool_lock(path):
            data = {"bits": bits, "safe_primes": []}
            if os.path.exists(path):
                data = _pool_read(path, bits)
            data["safe_primes"].append(str(p))
            _pool_write(path, data)
        made += 1


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


def gen_preparams(bits: int = PAILLIER_BITS, rng=secrets,
                  safe_primes: Optional[Tuple[int, int]] = None,
                  pool_path=None) -> PreParams:
    """A node's pre-parameters. ``safe_primes`` skips the search;
    ``pool_path`` takes them from a :func:`pool_take` file. NTilde from
    two safe primes, h1 a random square, h2 = h1^alpha."""
    half = bits // 2
    if safe_primes is not None:
        P, Q = safe_primes
    elif pool_path is not None:
        P, Q = pool_take(pool_path, count=2, bits=half, rng=rng)
    else:
        P = gen_safe_prime(half, rng)
        while True:
            Q = gen_safe_prime(half, rng)
            if Q != P:
                break
    NTilde = P * Q
    pq = (P - 1) // 2 * ((Q - 1) // 2)  # order of the squares subgroup
    f = rng.randbelow(NTilde - 2) + 2
    h1 = f * f % NTilde
    alpha = rng.randbelow(pq - 1) + 1
    beta = pow(alpha, -1, pq)
    h2 = pow(h1, alpha, NTilde)
    key = gen_paillier_key(bits, rng)
    return PreParams(paillier=key, NTilde=NTilde, h1=h1, h2=h2, alpha=alpha, beta=beta,
                     P=P, Q=Q)
