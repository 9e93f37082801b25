"""Host-side (python-int) secp256k1 and edwards25519 arithmetic and
Shamir sharing.

The port's own copy of what the signing slices need from the JAX
package's ``core/hostmath.py``: curve constants, point arithmetic,
SEC1 and RFC 8032 encodings, ECDSA and Ed25519 verification (the
independent check of every signature the device path produces) and
Shamir/Lagrange helpers for the trusted-dealer keygen.
"""
from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass
from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# edwards25519 (RFC 8032)
# ---------------------------------------------------------------------------

ED_P = 2**255 - 19
ED_L = 2**252 + 27742317777372353535851937790883648493
ED_D = (-121665 * pow(121666, -1, ED_P)) % ED_P


def _ed_recover_x(y: int, sign: int) -> Optional[int]:
    if y >= ED_P:
        return None
    x2 = (y * y - 1) * pow(ED_D * y * y + 1, -1, ED_P) % ED_P
    if x2 == 0:
        return None if sign else 0
    # p = 5 mod 8 → sqrt via x2^((p+3)/8), correct by sqrt(-1) if needed
    x = pow(x2, (ED_P + 3) // 8, ED_P)
    if (x * x - x2) % ED_P != 0:
        x = x * pow(2, (ED_P - 1) // 4, ED_P) % ED_P
    if (x * x - x2) % ED_P != 0:
        return None
    if (x & 1) != sign:
        x = ED_P - x
    return x


@dataclass(frozen=True)
class EdPoint:
    """Extended twisted-Edwards coordinates (X:Y:Z:T), x*y = T*Z."""

    X: int
    Y: int
    Z: int
    T: int

    def __add__(self, other: "EdPoint") -> "EdPoint":
        return ed_add(self, other)

    def __rmul__(self, k: int) -> "EdPoint":
        return ed_mul(k, self)

    def affine(self) -> Tuple[int, int]:
        zi = pow(self.Z, -1, ED_P)
        return self.X * zi % ED_P, self.Y * zi % ED_P

    def equals(self, other: "EdPoint") -> bool:
        # cross-multiplied comparison, Z-invariant
        return (
            (self.X * other.Z - other.X * self.Z) % ED_P == 0
            and (self.Y * other.Z - other.Y * self.Z) % ED_P == 0
        )


ED_IDENT = EdPoint(0, 1, 1, 0)
_BY = 4 * pow(5, -1, ED_P) % ED_P
_BX = _ed_recover_x(_BY, 0)
ED_B = EdPoint(_BX, _BY, 1, _BX * _BY % ED_P)


def ed_add(a: EdPoint, b: EdPoint) -> EdPoint:
    """Unified (complete) addition — same formula for double and add."""
    p = ED_P
    A = (a.Y - a.X) * (b.Y - b.X) % p
    Bv = (a.Y + a.X) * (b.Y + b.X) % p
    C = 2 * a.T * b.T * ED_D % p
    Dv = 2 * a.Z * b.Z % p
    E, F, G, H = Bv - A, Dv - C, Dv + C, Bv + A
    return EdPoint(E * F % p, G * H % p, F * G % p, E * H % p)


def ed_mul(k: int, pt: EdPoint) -> EdPoint:
    """Scalar multiplication. Does not reduce k mod ED_L: RFC 8032
    cofactorless verification relies on the unreduced hash scalar when
    the input point has a torsion component."""
    if k < 0:
        raise ValueError("negative scalar")
    acc = ED_IDENT
    add = pt
    while k:
        if k & 1:
            acc = ed_add(acc, add)
        add = ed_add(add, add)
        k >>= 1
    return acc


def ed_compress(pt: EdPoint) -> bytes:
    x, y = pt.affine()
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def ed_decompress(data: bytes) -> EdPoint:
    assert len(data) == 32
    raw = int.from_bytes(data, "little")
    sign = raw >> 255
    y = raw & ((1 << 255) - 1)
    x = _ed_recover_x(y, sign)
    if x is None:
        raise ValueError("not a curve point")
    return EdPoint(x, y, 1, x * y % ED_P)


def sha512_int_le(*chunks: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(chunks)).digest(), "little")


def ed25519_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """RFC 8032 verification (the independent check for threshold outputs)."""
    if len(sig) != 64:
        return False
    try:
        A = ed_decompress(pub)
        R = ed_decompress(sig[:32])
    except ValueError:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= ED_L:
        return False
    h = sha512_int_le(sig[:32], pub, msg)  # unreduced: cofactorless verify
    lhs = ed_mul(s, ED_B)
    rhs = ed_add(R, ed_mul(h, A))
    return lhs.equals(rhs)


def _ed_secret_scalar(seed: bytes) -> Tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def ed25519_sign_plain(seed: bytes, msg: bytes) -> bytes:
    """Single-party RFC 8032 signing (test harness)."""
    a, prefix = _ed_secret_scalar(seed)
    A = ed_compress(ed_mul(a, ED_B))
    r = sha512_int_le(prefix, msg) % ED_L
    Rb = ed_compress(ed_mul(r, ED_B))
    k = sha512_int_le(Rb, A, msg) % ED_L
    s = (r + k * a) % ED_L
    return Rb + s.to_bytes(32, "little")


def ed25519_public_from_seed(seed: bytes) -> bytes:
    return ed_compress(ed_mul(_ed_secret_scalar(seed)[0], ED_B))


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


def shamir_reconstruct(shares: dict, order: int, at: int = 0) -> int:
    xs = list(shares)
    acc = 0
    for x_i, y_i in shares.items():
        acc = (acc + y_i * lagrange_coeff(xs, x_i, order, at)) % order
    return acc
