"""Batched edwards25519 group operations (PyTorch).

The port of ``mpcium_tpu/core/ed25519_jax.py``. Points are extended
twisted-Edwards coordinates (X:Y:Z:T) with x·y = T·Z on -x² + y² =
1 + d·x²·y², each coordinate a weak field element of
``fields.ed25519_field`` (float64 limbs) with any leading batch shape.
The unified addition (HWCD08 "add-2008-hwcd-3") and the doubling of RFC
8032 §5.1.4 are complete on the curve: no branches, no exceptional
inputs.

Every output that leaves this module (RFC 8032 encodings, equality, ok
masks) is a function of the group element only, so it matches the JAX
package byte for byte even where the ladders differ:

* :func:`scalar_mul` (variable base) uses 4-bit fixed windows over a
  per-element table 0·P … 15·P: 256 doublings and 64 additions instead
  of 256 + 256.
* :func:`base_mul` (fixed base B) is a comb of 8-bit windows over a host
  table of d·2^(8i)·B: 32 additions of an affine table entry, no
  doublings, instead of 256 conditional additions.

Table entries are kept in the forms that save a multiply per addition:
affine entries as (y+x, y-x, 2d·x·y), projective ones as (Y+X, Y-X, 2Z,
2d·T). The products of each formula run as one stacked multiply per
dependency layer.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import bignum as bn
from . import hostmath as hm
from .fields import ed25519_field

PROF = bn.P256
SCALAR_BITS = 256
_COMB_W = 8
F64 = torch.float64


class EdPointJ(NamedTuple):
    """Batch of extended-coordinate points; fields shaped (..., 22)."""

    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor
    T: torch.Tensor

    @property
    def batch_shape(self):
        return self.X.shape[:-1]


def _dev(device) -> Optional[torch.device]:
    return torch.device(device) if device is not None else None


def _field(t: torch.Tensor):
    return ed25519_field(t.device)


def identity(batch_shape=(), device=None) -> EdPointJ:
    F = ed25519_field(_dev(device))
    zero, one = F.const(0, batch_shape), F.const(1, batch_shape)
    return EdPointJ(zero, one, one, zero)


def from_host(points, device=None) -> EdPointJ:
    """Build a batch from host points (hostmath.EdPoint or (x, y) ints)."""
    F = ed25519_field(_dev(device))
    xs, ys = [], []
    for pt in points:
        x, y = pt.affine() if isinstance(pt, hm.EdPoint) else pt
        xs.append(x)
        ys.append(y)
    X, Y = (torch.as_tensor(F.from_ints(v), dtype=F64, device=device) for v in (xs, ys))
    return EdPointJ(X, Y, F.const(1, X.shape[:-1]).clone(), F.mul(X, Y))


def to_host(p: EdPointJ) -> list:
    """Batch → list of hostmath.EdPoint."""
    F = _field(p.X)
    cols = [F.to_ints(c) for c in p]
    return [hm.EdPoint(x, y, z, t) for x, y, z, t in zip(*cols)]


def _stack(*ts) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*ts))


@functools.lru_cache(maxsize=None)
def _d2(device) -> torch.Tensor:
    return ed25519_field(device).const(2 * hm.ED_D % hm.ED_P)


def _add_cached(a: EdPointJ, ypx, ymx, t2d, z2=None) -> EdPointJ:
    """a + b, with b given as (Y+X, Y-X, 2d·T, 2Z) — or, for an affine b
    (Z = 1), as (y+x, y-x, 2d·x·y) with ``z2`` None."""
    F = _field(a.X)
    s, d = F.add(a.Y, a.X), F.sub(a.Y, a.X)
    if z2 is None:
        B, A, C = F.mul(_stack(s, d, a.T), _stack(ypx, ymx, t2d)).unbind(0)
        D = F.add(a.Z, a.Z)
    else:
        B, A, C, D = F.mul(_stack(s, d, a.T, a.Z), _stack(ypx, ymx, t2d, z2)).unbind(0)
    E, Fv = F.sub(_stack(B, D), _stack(A, C)).unbind(0)
    G, H = F.add(_stack(D, B), _stack(C, A)).unbind(0)
    X3, Y3, T3, Z3 = F.mul(_stack(E, G, E, Fv), _stack(Fv, H, H, G)).unbind(0)
    return EdPointJ(X3, Y3, Z3, T3)


def _cached(b: EdPointJ):
    """(Y+X, Y-X, 2d·T, 2Z) of a batch of points."""
    F = _field(b.X)
    return (F.add(b.Y, b.X), F.sub(b.Y, b.X), F.mul(b.T, _d2(b.X.device)),
            F.add(b.Z, b.Z))


def add(a: EdPointJ, b: EdPointJ) -> EdPointJ:
    """Unified complete addition (RFC 8032 / HWCD08 'add-2008-hwcd-3')."""
    return _add_cached(a, *_cached(b))


def double(a: EdPointJ) -> EdPointJ:
    """Complete doubling (RFC 8032 §5.1.4), two stacked multiplies."""
    F = _field(a.X)
    A, B, ZZ, S = F.square(_stack(a.X, a.Y, a.Z, F.add(a.X, a.Y))).unbind(0)
    H, C = F.add(_stack(A, ZZ), _stack(B, ZZ)).unbind(0)  # A + B, 2·Z²
    E, G = F.sub(_stack(H, A), _stack(S, B)).unbind(0)  # H - (X+Y)², A - B
    Fv = F.add(C, G)
    X3, Y3, T3, Z3 = F.mul(_stack(E, G, E, Fv), _stack(Fv, H, H, G)).unbind(0)
    return EdPointJ(X3, Y3, Z3, T3)


def select(mask: torch.Tensor, a: EdPointJ, b: EdPointJ) -> EdPointJ:
    """mask ? a : b, elementwise over the batch (mask: bool (...,))."""
    m = mask[..., None]
    return EdPointJ(*(torch.where(m, x, y) for x, y in zip(a, b)))


def scalars_to_bits(ks, n_bits: int = SCALAR_BITS) -> np.ndarray:
    """Host ints → (batch, n_bits) int32 little-endian bit array."""
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


def _gather(tbl, d: torch.Tensor) -> list:
    """Fields (..., k, 22) of a table, digits d (...,) → fields (..., 22)."""
    idx = d.to(torch.int64)[..., None, None].expand(d.shape + (1, PROF.n_limbs))
    return [c.gather(-2, idx).squeeze(-2) for c in tbl]


def scalar_mul(bits: torch.Tensor, p: EdPointJ) -> EdPointJ:
    """Variable-base k·P; bits (..., n) LSB-first. 4-bit fixed windows
    over a per-element table 0·P … 15·P."""
    shape = torch.broadcast_shapes(bits.shape[:-1], p.batch_shape)
    p = EdPointJ(*(c.expand(shape + (PROF.n_limbs,)) for c in p))
    pc = _cached(p)
    rows = [identity(shape, p.X.device), p]
    for i in range(2, 16):
        rows.append(double(rows[i // 2]) if i % 2 == 0 else _add_cached(rows[-1], *pc))
    ext = EdPointJ(*(torch.stack([r[c] for r in rows], -2) for c in range(4)))
    cached = _cached(ext)  # four (..., 16, 22) fields
    digits = _digits(bits, 4).expand(shape + (-(-bits.shape[-1] // 4),))
    nw = digits.shape[-1]
    acc = EdPointJ(*_gather(ext, digits[..., nw - 1]))
    for i in range(nw - 2, -1, -1):
        for _ in range(4):
            acc = double(acc)
        acc = _add_cached(acc, *_gather(cached, digits[..., i]))
    return acc


@functools.lru_cache(maxsize=None)
def _comb_table(device) -> torch.Tensor:
    """(32, 256, 3, 22): entry [i, d] = d·2^(8i)·B as (y+x, y-x, 2d·x·y)."""
    F = ed25519_field(device)
    p, nw, rows = hm.ED_P, SCALAR_BITS // _COMB_W, 1 << _COMB_W
    vals = []
    base = hm.ED_B
    for _ in range(nw):
        acc = hm.ED_IDENT
        for _d in range(rows):
            x, y = acc.affine()
            vals += [(y + x) % p, (y - x) % p, 2 * hm.ED_D * x * y % p]
            acc = hm.ed_add(acc, base)
        base = acc  # 256·base
    return torch.as_tensor(
        F.from_ints(vals).reshape(nw, rows, 3, PROF.n_limbs), dtype=F64, device=device
    )


def base_mul(bits: torch.Tensor) -> EdPointJ:
    """Fixed-base k·B; bits (..., 256) LSB-first. Comb of 8-bit windows:
    one table lookup and one addition per window, no doublings."""
    tbl = _comb_table(bits.device)
    digits = _digits(bits[..., :SCALAR_BITS], _COMB_W)
    acc = identity(digits.shape[:-1], bits.device)
    for i in range(digits.shape[-1]):
        acc = _add_cached(acc, *tbl[i][digits[..., i]].unbind(-2))
    return acc


@functools.lru_cache(maxsize=None)
def scalar_ring(device=None) -> bn.BarrettCtx:
    """Barrett context for the group order l (the EdDSA scalar ring)."""
    return bn.BarrettCtx(hm.ED_L, PROF, device=device)


@functools.lru_cache(maxsize=None)
def _p_limbs(device) -> torch.Tensor:
    return torch.as_tensor(bn.to_limbs(hm.ED_P, PROF), device=device)


def decompress(b: torch.Tensor) -> Tuple[EdPointJ, torch.Tensor]:
    """Batch RFC 8032 decode: (..., 32) uint8 → (EdPointJ, ok mask).

    Invalid encodings (y ≥ p, non-residue x², x = 0 with sign = 1) yield
    the identity with ok = False — callers mask, never branch. Square
    root per p ≡ 5 (mod 8): x = u·v³·(u·v⁷)^((p-5)/8), fixed up by √-1.
    """
    F = ed25519_field(b.device)
    sign = (b[..., 31] >> 7).to(torch.int64)
    y_bytes = torch.cat([b[..., :31], b[..., 31:] & 0x7F], -1)
    y_int = bn.bytes_to_limbs_le(y_bytes, PROF, PROF.n_limbs)
    ok = bn.compare(y_int, _p_limbs(b.device)) < 0
    y = F.from_limbs(y_int)
    batch = y.shape[:-1]
    y2 = F.square(y)
    one = F.one_like(y2)
    u = F.sub(y2, one)
    v = F.add(F.mul(F.const(hm.ED_D, batch), y2), one)
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    pw = F.pow_const(F.mul(u, v7), (hm.ED_P - 5) // 8)
    x = F.mul(F.mul(u, v3), pw)
    vx2 = F.mul(v, F.square(x))
    is_u = F.eq(vx2, u)
    is_neg_u = F.eq(vx2, F.neg(u))
    sqrt_m1 = F.const(pow(2, (hm.ED_P - 1) // 4, hm.ED_P), batch)
    x = torch.where(is_neg_u[..., None], F.mul(x, sqrt_m1), x)
    ok = ok & (is_u | is_neg_u)
    xc = F.canonical(x)
    x_is_zero = torch.all(xc == 0, dim=-1)
    ok = ok & ~(x_is_zero & (sign == 1))
    flip = (xc[..., 0] & 1).to(torch.int64) != sign
    x = torch.where(flip[..., None], F.neg(x), x)
    pt = EdPointJ(x, y, F.one_like(y), F.mul(x, y))
    return select(ok, pt, identity(batch, b.device)), ok


def equal(a: EdPointJ, b: EdPointJ) -> torch.Tensor:
    """Batch equality, Z-invariant: X1·Z2 == X2·Z1 and Y1·Z2 == Y2·Z1."""
    F = _field(a.X)
    m = F.mul(_stack(a.X, b.X, a.Y, b.Y), _stack(b.Z, a.Z, b.Z, a.Z))
    ex, ey = F.is_zero(F.sub(m[0::2], m[1::2])).unbind(0)
    return ex & ey


def compress(p: EdPointJ) -> torch.Tensor:
    """Batch compress → (..., 32) uint8, RFC 8032 encoding (little-endian
    y with the sign of x in the top bit)."""
    F = _field(p.X)
    zi = F.inv(p.Z)
    x, y = F.canonical(F.mul(_stack(p.X, p.Y), zi)).unbind(0)
    return _pack_bytes_le(y, sign=x[..., 0] & 1)


def _pack_bytes_le(limbs: torch.Tensor, sign=None) -> torch.Tensor:
    """Canonical 22×12-bit limbs (values < 2^256) → 32 bytes little-endian;
    ``sign`` goes into bit 255, which is 0 for a canonical y < p."""
    out = bn.limbs_to_bytes_le(limbs, PROF, 32)
    if sign is None:
        return out
    top = out[..., 31:] | (sign.to(torch.uint8)[..., None] << 7)
    return torch.cat([out[..., :31], top], -1)
