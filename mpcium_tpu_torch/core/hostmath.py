"""Host-side (python-int) secp256k1 arithmetic and Shamir sharing.

The port's own copy of what the signing slice needs from the JAX
package's ``core/hostmath.py``: curve constants, affine point
arithmetic, SEC1 encodings, ECDSA verification (the independent check of
every signature the device path produces) and Shamir/Lagrange helpers
for the trusted-dealer keygen.
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional

SECP_P = 2**256 - 2**32 - 977
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
SECP_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


@dataclass(frozen=True)
class SecpPoint:
    """Affine secp256k1 point; None coordinates encode the identity."""

    x: Optional[int]
    y: Optional[int]

    @property
    def is_infinity(self) -> bool:
        return self.x is None


SECP_INF = SecpPoint(None, None)
SECP_G = SecpPoint(SECP_GX, SECP_GY)


def secp_add(a: SecpPoint, b: SecpPoint) -> SecpPoint:
    if a.is_infinity:
        return b
    if b.is_infinity:
        return a
    p = SECP_P
    if a.x == b.x:
        if (a.y + b.y) % p == 0:
            return SECP_INF
        lam = (3 * a.x * a.x) * pow(2 * a.y, -1, p) % p
    else:
        lam = (b.y - a.y) * pow(b.x - a.x, -1, p) % p
    x3 = (lam * lam - a.x - b.x) % p
    y3 = (lam * (a.x - x3) - a.y) % p
    return SecpPoint(x3, y3)


def secp_mul(k: int, pt: SecpPoint) -> SecpPoint:
    k %= SECP_N
    acc = SECP_INF
    add = pt
    while k:
        if k & 1:
            acc = secp_add(acc, add)
        add = secp_add(add, add)
        k >>= 1
    return acc


def secp_compress(pt: SecpPoint) -> bytes:
    """SEC1 compressed encoding (33 bytes)."""
    assert not pt.is_infinity
    return bytes([2 + (pt.y & 1)]) + pt.x.to_bytes(32, "big")


def secp_decompress(data: bytes) -> SecpPoint:
    assert len(data) == 33 and data[0] in (2, 3)
    x = int.from_bytes(data[1:], "big")
    if x >= SECP_P:
        raise ValueError("x out of field range")
    y2 = (pow(x, 3, SECP_P) + 7) % SECP_P
    y = pow(y2, (SECP_P + 1) // 4, SECP_P)
    if y * y % SECP_P != y2:
        raise ValueError("not a curve point")
    if (y & 1) != (data[0] & 1):
        y = SECP_P - y
    return SecpPoint(x, y)


def ecdsa_verify(pub: SecpPoint, digest: int, r: int, s: int) -> bool:
    """Standard ECDSA verification over secp256k1."""
    if not (1 <= r < SECP_N and 1 <= s < SECP_N):
        return False
    w = pow(s, -1, SECP_N)
    u1 = digest * w % SECP_N
    u2 = r * w % SECP_N
    pt = secp_add(secp_mul(u1, SECP_G), secp_mul(u2, pub))
    if pt.is_infinity:
        return False
    return pt.x % SECP_N == r


def poly_eval(coeffs, x: int, order: int) -> int:
    """sum(coeffs[i] * x^i) mod order (Horner)."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % order
    return acc


def shamir_share(secret: int, threshold: int, xs, order: int, rng=secrets):
    """Degree-``threshold`` sharing: t+1 shares reconstruct."""
    coeffs = [secret] + [rng.randbelow(order - 1) + 1 for _ in range(threshold)]
    return coeffs, {x: poly_eval(coeffs, x, order) for x in xs}


def lagrange_coeff(xs, x_i: int, order: int, at: int = 0) -> int:
    """Lagrange basis polynomial for x_i over points xs, evaluated at ``at``."""
    num, den = 1, 1
    for x_j in xs:
        if x_j == x_i:
            continue
        num = num * ((at - x_j) % order) % order
        den = den * ((x_i - x_j) % order) % order
    return num * pow(den, -1, order) % order
