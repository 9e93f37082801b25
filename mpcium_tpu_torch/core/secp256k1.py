"""Batched secp256k1 group operations (PyTorch).

The port of ``mpcium_tpu/core/secp256k1_jax.py``: projective points
(X:Y:Z) on y² = x³ + 7 with the complete formulas of Renes–Costello–
Batina 2015 (Algorithm 7 for addition, Algorithm 9 for doubling, a = 0),
valid for every input including the identity (0:1:0).

Every output that leaves this module (compressed encodings, affine x,
equality) is a function of the group element only, so it matches the
JAX package byte for byte even where the ladders differ: variable-base
multiplication uses 4-bit fixed windows (256 doublings + 64 additions
instead of 256 + 256), and fixed-base multiplication a comb of 8-bit
windows over a host table of d·2^(8i)·G (32 additions instead of 256).
The ladders are Python loops over windows; nothing scans over limbs.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import bignum as bn
from . import hostmath as hm
from .fields import Secp256k1Sqrt, secp256k1_field

PROF = bn.P256
SCALAR_BITS = 256
_B3 = 21  # 3·b for b = 7
_COMB_W = 8


class SecpPointJ(NamedTuple):
    """Batch of projective points; fields shaped (..., 22)."""

    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor

    @property
    def batch_shape(self):
        return self.X.shape[:-1]


def _field(t: torch.Tensor):
    return secp256k1_field(t.device)


def identity(batch_shape=(), device=None) -> SecpPointJ:
    F = secp256k1_field(torch.device(device) if device is not None else None)
    z = F.const(0, batch_shape)
    return SecpPointJ(z, F.const(1, batch_shape), z)


def from_host(points, device=None) -> SecpPointJ:
    """hostmath.SecpPoint list (no identities) → batch."""
    F = secp256k1_field(torch.device(device) if device is not None else None)
    X, Y = (
        torch.as_tensor(F.from_ints(v), dtype=torch.float64, device=device)
        for v in ([p.x for p in points], [p.y for p in points])
    )
    return SecpPointJ(X, Y, F.const(1, (len(points),)).clone())


def to_host(p: SecpPointJ) -> list:
    """Batch → list of affine hostmath.SecpPoint (identity-aware)."""
    F = _field(p.X)
    zs, xs, ys = F.to_ints(p.Z), F.to_ints(p.X), F.to_ints(p.Y)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(hm.SECP_INF)
        else:
            zi = pow(z, -1, hm.SECP_P)
            out.append(hm.SecpPoint(x * zi % hm.SECP_P, y * zi % hm.SECP_P))
    return out


def _stack(*ts) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*ts))


def add(a: SecpPointJ, b: SecpPointJ) -> SecpPointJ:
    """Complete addition, RCB15 Algorithm 7 (a=0, b3=21). The twelve
    products run as two stacked multiplies of six (the formula's two
    dependency layers), the sums likewise."""
    F = _field(a.X)
    P1, P2 = _stack(a.X, a.Y, a.Z), _stack(b.X, b.Y, b.Z)
    # rows rotated (1, 2, 0) by a roll: an index list would upload from the
    # host on every call, which a CUDA graph capture forbids
    # t0 t1 t2 = X1X2 Y1Y2 Z1Z2; t3 t4 x3 = (X1+Y1)(X2+Y2) (Y1+Z1)(Y2+Z2)
    # (Z1+X1)(Z2+X2)
    m = F.mul(
        torch.cat([P1, F.add(P1, P1.roll(-1, 0))]), torch.cat([P2, F.add(P2, P2.roll(-1, 0))])
    )
    # t3 - (t0+t1), t4 - (t1+t2), x3 - (t2+t0)
    T3, T4, Y3 = F.sub(m[3:], F.add(m[:3], m[:3].roll(-1, 0))).unbind(0)
    t0, t1 = m[0], m[1]
    t0x3 = F.mul_small(t0, 3)
    t2b, y3b = F.mul_small(_stack(m[2], Y3), _B3).unbind(0)
    z3 = F.add(t1, t2b)
    t1b = F.sub(t1, t2b)
    M = F.mul(
        _stack(T4, T3, y3b, t1b, t0x3, z3), _stack(y3b, t1b, t0x3, z3, T3, T4)
    )
    # X3 = t3·t1 - t4·y3; Y3 = t1·z3 + y3·t0; Z3 = z3·t4 + t0·t3
    X3 = F.sub(M[1], M[0])
    Y3, Z3 = F.add(M[3::2], M[2:5:2]).unbind(0)
    return SecpPointJ(X3, Y3, Z3)


def double(a: SecpPointJ) -> SecpPointJ:
    """Complete doubling, RCB15 Algorithm 9 (a=0, b3=21), as two stacked
    multiplies of four."""
    F = _field(a.X)
    # t0 = Y², t1 = YZ, t2 = Z², xy = XY
    t0, t1, t2, xy = F.mul(_stack(a.Y, a.Y, a.Z, a.X), _stack(a.Y, a.Z, a.Z, a.Y))
    z3, t2 = F.mul_small(_stack(t0, t2), _fac_8_21(t0.device, t0.dim())).unbind(0)
    y3 = F.add(t0, t2)
    t0 = F.sub(t0, F.mul_small(t2, 3))
    x3, z3, y3, xx = F.mul(_stack(t2, t1, t0, t0), _stack(z3, z3, y3, xy))
    Y3, X3 = F.add(_stack(x3, xx), _stack(y3, xx)).unbind(0)
    return SecpPointJ(X3, Y3, z3)


@functools.lru_cache(maxsize=None)
def _fac_8_21(device, ndim: int) -> torch.Tensor:
    """The factors (8, 21) of 8·Y² and 21·Z², shaped to scale a stack of
    two (..., 22) fields; cached per device, so no ladder step uploads."""
    return torch.tensor([8.0, 21.0], dtype=torch.float64, device=device).view(
        (2,) + (1,) * ndim)


def select(mask: torch.Tensor, a: SecpPointJ, b: SecpPointJ) -> SecpPointJ:
    m = mask[..., None]
    return SecpPointJ(
        torch.where(m, a.X, b.X), torch.where(m, a.Y, b.Y),
        torch.where(m, a.Z, b.Z),
    )


def _gather_pt(tbl: SecpPointJ, d: torch.Tensor) -> SecpPointJ:
    """tbl fields (..., k, 22), d (...,) indices → point (..., 22)."""
    idx = d.to(torch.int64)[..., None, None].expand(d.shape + (1, PROF.n_limbs))
    return SecpPointJ(*(c.gather(-2, idx).squeeze(-2) for c in tbl))


def scalars_to_bits(ks, n_bits: int = SCALAR_BITS) -> np.ndarray:
    out = np.zeros((len(ks), n_bits), dtype=np.int32)
    for i, k in enumerate(ks):
        assert 0 <= k < 1 << n_bits
        for j in range(n_bits):
            out[i, j] = (k >> j) & 1
    return out


def _digits(bits: torch.Tensor, w: int) -> torch.Tensor:
    """(..., n) LSB-first bits → (..., ceil(n/w)) w-bit digits, LSD first."""
    n = bits.shape[-1]
    nw = -(-n // w)
    b = bn.pad_limbs(bits.to(torch.int64), nw * w - n)
    return (b.reshape(bits.shape[:-1] + (nw, w)) << bn._arange(w, bits.device)).sum(-1)


def scalar_mul(bits: torch.Tensor, p: SecpPointJ) -> SecpPointJ:
    """Variable-base k·P; bits (..., n) LSB-first. 4-bit fixed windows
    over a per-element table 0·P … 15·P."""
    shape = torch.broadcast_shapes(bits.shape[:-1], p.batch_shape)
    p = SecpPointJ(*(c.expand(shape + (PROF.n_limbs,)) for c in p))
    rows = [identity(shape, p.X.device), p]
    for i in range(2, 16):
        rows.append(double(rows[i // 2]) if i % 2 == 0 else add(rows[-1], p))
    tbl = SecpPointJ(*(torch.stack([r[c] for r in rows], -2) for c in range(3)))
    digits = _digits(bits, 4).expand(shape + (-(-bits.shape[-1] // 4),))
    acc = None
    for i in range(digits.shape[-1] - 1, -1, -1):
        sel = _gather_pt(tbl, digits[..., i])
        if acc is None:
            acc = sel
            continue
        for _ in range(4):
            acc = double(acc)
        acc = add(acc, sel)
    return acc


@functools.lru_cache(maxsize=None)
def _comb_table(device) -> SecpPointJ:
    """(32, 256, 22) fields: entry [i, d] = d·2^(8i)·G (identity at d=0)."""
    F = secp256k1_field(device)
    nw, rows = SCALAR_BITS // _COMB_W, 1 << _COMB_W
    xs, ys, zs = [], [], []
    base = hm.SECP_G
    for _ in range(nw):
        acc = hm.SECP_INF
        for d in range(rows):
            if acc.is_infinity:
                xs.append(0), ys.append(1), zs.append(0)
            else:
                xs.append(acc.x), ys.append(acc.y), zs.append(1)
            acc = hm.secp_add(acc, base)
        base = acc  # 256·base
    shape = (nw, rows, PROF.n_limbs)
    return SecpPointJ(*(
        torch.as_tensor(
            F.from_ints(v).reshape(shape), dtype=torch.float64, device=device
        )
        for v in (xs, ys, zs)
    ))


def base_mul(bits: torch.Tensor) -> SecpPointJ:
    """Fixed-base k·G; bits (..., 256) LSB-first. Comb of 8-bit windows:
    one table lookup and one addition per window, no doublings."""
    tbl = _comb_table(bits.device)
    digits = _digits(bits[..., :SCALAR_BITS], _COMB_W)
    acc = None
    for i in range(digits.shape[-1]):
        row = SecpPointJ(*(c[i] for c in tbl))  # (256, 22)
        sel = SecpPointJ(*(c[digits[..., i]] for c in row))
        acc = sel if acc is None else add(acc, sel)
    return acc


@functools.lru_cache(maxsize=None)
def scalar_ring(device=None) -> bn.BarrettCtx:
    """Barrett context for the group order n (the ECDSA scalar ring)."""
    return bn.BarrettCtx(hm.SECP_N, PROF, device=device)


def neg(a: SecpPointJ) -> SecpPointJ:
    """Batch point negation (Y ↦ -Y)."""
    return SecpPointJ(a.X, _field(a.X).neg(a.Y), a.Z)


def equal(a: SecpPointJ, b: SecpPointJ) -> torch.Tensor:
    """Batch equality: cross-multiplied, Z-invariant, identity-aware."""
    F = _field(a.X)
    m = F.mul(_stack(a.X, b.X, a.Y, b.Y), _stack(b.Z, a.Z, b.Z, a.Z))
    d = F.sub(m[0::2], m[1::2])  # X1Z2 - X2Z1, Y1Z2 - Y2Z1
    zero = torch.all(F.canonical(torch.cat([d, _stack(a.Z, b.Z)])) == 0, -1)
    ex, ey, za, zb = zero.unbind(0)
    return torch.where(za | zb, za == zb, ex & ey)


def x_coordinate(p: SecpPointJ) -> torch.Tensor:
    """Affine x as canonical limbs (the ECDSA r source)."""
    F = _field(p.X)
    return F.canonical(F.mul(p.X, F.inv(p.Z)))


def compress(p: SecpPointJ) -> torch.Tensor:
    """Batch SEC1 compressed encoding → (..., 33) uint8 big-endian."""
    F = _field(p.X)
    zi = F.inv(p.Z)
    x = F.canonical(F.mul(p.X, zi))
    y = F.canonical(F.mul(p.Y, zi))
    tag = (2 + (y[..., :1] & 1)).to(torch.uint8)
    return torch.cat([tag, pack_be_32(x)], -1)


def pack_be_32(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical limbs (< 2^256) → (..., 32) uint8 big-endian."""
    return torch.flip(bn.limbs_to_bytes_le(limbs, PROF, 32), dims=(-1,))


@functools.lru_cache(maxsize=None)
def _sqrt_ctx(device=None):
    return Secp256k1Sqrt(device)


def decompress(b: torch.Tensor) -> Tuple[SecpPointJ, torch.Tensor]:
    """Batch SEC1 decompression: (..., 33) uint8 → (SecpPointJ, ok mask).

    Bad encodings (wrong tag, x ≥ p, non-residue) yield ok=False with an
    arbitrary valid-shape point — callers gate on the mask."""
    F = secp256k1_field(b.device)
    tag = b[..., 0].to(torch.int64)
    x = bn.bytes_to_limbs_le(torch.flip(b[..., 1:], dims=(-1,)), PROF, PROF.n_limbs)
    p_l = bn.const_limbs(hm.SECP_P, PROF, b.device)
    ok = (bn.compare(x, p_l) < 0) & ((tag == 2) | (tag == 3))
    rhs = F.add(F.mul(F.square(x), x), F.const(7, x.shape[:-1]))
    y, has_root = _sqrt_ctx(b.device).sqrt(rhs)
    ok = ok & has_root
    y = F.canonical(y)
    flip = (y[..., 0] & 1) != (tag & 1)
    y = torch.where(flip[..., None], F.canonical(F.neg(y)), y)
    one = F.const(1, x.shape[:-1])
    return SecpPointJ(F.from_limbs(x), F.from_limbs(y), one), ok
