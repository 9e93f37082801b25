"""Batched modular arithmetic for the Paillier / ring-Pedersen widths.

The port of ``mpcium_tpu/ops/modmul.py``. Representation: little-endian
int32 limb tensors, 7 bits per limb (radix 128), shape (..., n_limbs),
normalized unless stated otherwise — the JAX package's layout.

* Products by a per-modulus constant are Toeplitz matmuls, contracted in
  float64 (exact: every column sum < 2^24 ≪ 2^53).
* Carries are the vectorized roll passes + carry-lookahead of
  :func:`core.bignum.carry`.
* Conditional subtraction adds the radix complement R^(occ+1) - m and
  reads the top limb.
* Every modular multiply — ``mulmod`` and each step of the powmod loops —
  goes through :mod:`ops.mulmod`: the CUDA kernel for CUDA tensors, its
  plain version for CPU tensors.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..core import bignum as bn
from ..core.bignum import F64, I32, I64
from . import mulmod as K

LIMB_BITS = 7
RADIX = 1 << LIMB_BITS
MASK = RADIX - 1
_BLOCK = 32
COMB_W = 8
# same exactness domain as the JAX package: pairwise products up to 32
# blocks (7280-bit operands), constant products up to 1040 input limbs
_MAX_BLOCKS = 32
_MAX_CONST_LIMBS = 1040


def profile(value_bits: int) -> bn.LimbProfile:
    """7-bit limb profile sized for ``value_bits``, block-aligned."""
    n = -(-value_bits // LIMB_BITS)
    n = -(-n // _BLOCK) * _BLOCK
    return bn.LimbProfile(bits=LIMB_BITS, n_limbs=n)


_P7 = bn.LimbProfile(bits=LIMB_BITS, n_limbs=1)


def carry(x: torch.Tensor, in_bits: int = 25) -> torch.Tensor:
    """Exact normalization of non-negative redundant 7-bit limbs → int32.
    ``in_bits`` bounds the input limbs (< 2^in_bits); every product column
    of this module stays below 2^24, sums of normalized limbs below 2^9."""
    return bn.carry(x, _P7, in_bits=in_bits, signed=False).to(I32)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _toeplitz_np(c_limbs: Tuple[int, ...], n_in: int) -> np.ndarray:
    """(n_in, n_in + len(c) - 1) band matrix T[i, i+j] = c[j]."""
    return bn.toeplitz_np(c_limbs, n_in)


def _const_limbs(value: int, min_limbs: int = 1) -> Tuple[int, ...]:
    limbs = []
    v = value
    while v:
        limbs.append(v & MASK)
        v >>= LIMB_BITS
    while len(limbs) < min_limbs:
        limbs.append(0)
    return tuple(limbs)


def _const_matrices(value: int, n_in: int, min_limbs: int = 1, device=None) -> torch.Tensor:
    """Toeplitz matrix of ``value`` for ``n_in``-limb inputs (float64)."""
    return torch.as_tensor(
        _toeplitz_np(_const_limbs(value, min_limbs), n_in), dtype=F64, device=device
    )


def ints_to_limbs(vals, prof: bn.LimbProfile) -> np.ndarray:
    """Bulk python-int → limb conversion (numpy speed)."""
    return bn.batch_to_limbs(vals, prof)


def mul_const(x: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """x (normalized limbs) times a constant via its Toeplitz matrix →
    UNNORMALIZED int32 columns (each < n_in·127² < 2^24; caller carries)."""
    return _mul_const64(x, T).to(I32)


def _mul_const64(x: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] != T.shape[0] or x.shape[-1] > _MAX_CONST_LIMBS:
        raise ValueError(
            f"mul_const: input width {x.shape[-1]} vs Toeplitz {tuple(T.shape)} "
            f"(exact up to {_MAX_CONST_LIMBS} limbs)"
        )
    return (x.to(F64) @ T).to(I64)


def mul_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise (batched × batched) product → normalized (n_x+n_y) limbs.
    Float64 block contraction (``bignum.columns``), then one carry."""
    n_x, n_y = x.shape[-1], y.shape[-1]
    bx, by = -(-n_x // _BLOCK), -(-n_y // _BLOCK)
    if min(bx, by) > _MAX_BLOCKS:
        raise ValueError(
            f"pairwise product beyond the exact domain: min({bx}, {by}) blocks "
            f"> {_MAX_BLOCKS} (operands up to {_MAX_BLOCKS * _BLOCK * LIMB_BITS} bits)"
        )
    cols = bn.pad_limbs(bn.columns(x, y), 1)
    return carry(cols)[..., : n_x + n_y]


# ---------------------------------------------------------------------------
# reduction pieces (operand-passing, per-modulus constants as arguments)
# ---------------------------------------------------------------------------


def _cond_sub_impl(x: torch.Tensor, comp: torch.Tensor, occ: int) -> torch.Tensor:
    """x < 2m over occ+1 limbs -> x mod m (complement-add carry)."""
    u = carry(bn.pad_limbs(x, 1) + comp, 10)  # x - m + R^(occ+1)
    ge = u[..., occ + 1: occ + 2] >= 1
    return torch.where(ge, u[..., : occ + 1], x)


def _cond_sub2_impl(x: torch.Tensor, comps: torch.Tensor, occ: int) -> torch.Tensor:
    """x < 3m over occ+1 limbs -> x mod m in one stacked carry: ``comps``
    holds R^(occ+1) - m and R^(occ+1) - 2m, and the top limb of each sum
    says whether x ≥ m, x ≥ 2m (the JAX package's two subtractions)."""
    u = carry(bn.pad_limbs(x, 1).unsqueeze(-2) + comps, 10)  # (..., 2, occ+2)
    ge = u[..., occ + 1: occ + 2] >= 1  # (..., 2, 1)
    return torch.where(
        ge[..., 1, :], u[..., 1, : occ + 1],
        torch.where(ge[..., 0, :], u[..., 0, : occ + 1], x),
    )


def _reduce_impl(x, T_mu, T_m, comps, occ: int, n: int) -> torch.Tensor:
    """Barrett reduce; x normalized <= 2n limbs, x < R^occ * m (any product
    of two reduced values qualifies) -> x mod m over n limbs. ``comps``:
    the (2, occ+2) stack of R^(occ+1) - m and R^(occ+1) - 2m."""
    if x.shape[-1] <= occ:
        x = bn.pad_limbs(x, occ + 2 - x.shape[-1])
    q1 = bn.take_limbs(x, occ - 1, x.shape[-1] - (occ - 1))
    q2 = carry(_mul_const64(q1, T_mu[: q1.shape[-1]]))
    q3 = bn.take_limbs(q2, occ + 1, q2.shape[-1] - (occ + 1))
    # r = x - q3·m over occ+1 limbs: the low occ+1 columns of q3·m are
    # subtracted unnormalized (higher columns only add multiples of
    # R^(occ+1)) and one signed carry mod R^(occ+2) leaves r in [0, 3m)
    q3m = _mul_const64(q3, T_m[: q3.shape[-1], : occ + 1])
    t = bn.pad_limbs(bn.take_limbs(x, 0, occ + 1) - q3m, 1)
    r = bn.carry(t, _P7, in_bits=25)[..., : occ + 1].to(I32)
    out = _cond_sub2_impl(r, comps, occ)[..., :occ]
    return bn.pad_limbs(out, n - occ) if occ < n else out


def _one_like(x: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(x.shape[:-1] + (n,), dtype=I32, device=x.device)
    out[..., 0] = 1
    return out


# ---------------------------------------------------------------------------
# the modular context
# ---------------------------------------------------------------------------


class MXUBarrett:
    """Barrett context for a fixed modulus on ``device`` (the name keeps
    the JAX package's, whose constant legs rode the TPU matrix unit).

    The modulus need NOT occupy the top limb (profiles are block-padded);
    the Barrett shift windows derive from the modulus' true occupancy.
    """

    def __init__(self, modulus: int, device=None):
        from ..device import resolve

        self.device = resolve(device)
        dev = self.device
        self.modulus = modulus
        mb = modulus.bit_length()
        occ = -(-mb // LIMB_BITS)
        self.prof = profile(mb)
        n = self.prof.n_limbs
        assert occ <= n
        self.occ = occ
        # mu = floor(R^(2·occ) / m); q1 = x >> (occ-1) limbs;
        # q3 = (q1·mu) >> (occ+1) limbs; r = x - q3·m over occ+1 limbs
        self.mu = (1 << (2 * occ * LIMB_BITS)) // modulus
        self._T_mu = _const_matrices(self.mu, 2 * n - (occ - 1), device=dev)
        self._T_m = _const_matrices(modulus, 2 * n, device=dev)
        comp = (1 << ((occ + 1) * LIMB_BITS)) - modulus
        self._comp = torch.as_tensor(
            bn.to_limbs(comp, self.prof, n_limbs=occ + 2), device=dev
        )
        comp2 = (1 << ((occ + 1) * LIMB_BITS)) - 2 * modulus
        self._comps = torch.stack([self._comp, torch.as_tensor(
            bn.to_limbs(comp2, self.prof, n_limbs=occ + 2), device=dev)])
        self._m1 = torch.as_tensor(bn.to_limbs(modulus, self.prof, occ + 1), device=dev)
        self._kc = K.make_consts(
            modulus, occ, n, self._T_mu, self._T_m, self._comps, dev
        )
        self._fb_tables: Dict = {}

    # -- helpers ------------------------------------------------------------

    def one_like(self, x: torch.Tensor) -> torch.Tensor:
        return _one_like(x, self.prof.n_limbs)

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return K.mulmod(a, b, self._kc)

    # -- core ---------------------------------------------------------------

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _reduce_impl(
            x, self._T_mu, self._T_m, self._comps, self.occ, self.prof.n_limbs
        )

    def mulmod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._mm(a, b)

    def mulmod_const(self, a: torch.Tensor, value: int) -> torch.Tensor:
        """a times a python-int constant (cached width-padded Toeplitz)."""
        key = ("constT", value % self.modulus)
        T = self._fb_tables.get(key)
        if T is None:
            T = _const_matrices(
                value % self.modulus, self.prof.n_limbs, min_limbs=self.occ,
                device=self.device,
            )
            self._fb_tables[key] = T
        return self.reduce(carry(mul_const(a, T)))

    def addmod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        occ, n = self.occ, self.prof.n_limbs
        s = carry(bn.pad_limbs(a + b, 1), 10)  # < 2m
        r = _cond_sub_impl(bn.take_limbs(s, 0, occ + 1), self._comp, occ)
        out = r[..., :occ]
        return bn.pad_limbs(out, n - occ) if occ < n else out

    def submod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        occ, n = self.occ, self.prof.n_limbs
        # a - b + m via the elementwise complement of b (non-negative limbs)
        t = (
            bn.take_limbs(a, 0, occ + 1)
            + (MASK - bn.take_limbs(b, 0, occ + 1))
            + bn.pad_limbs(self._m1, 1)[..., : occ + 1]
        )
        t = bn.pad_limbs(t, 1)
        t[..., 0] += 1
        r = carry(t, 10)[..., : occ + 1]  # a - b + m in (0, 2m); drop R^(occ+1)
        r = _cond_sub_impl(r, self._comp, occ)
        out = r[..., :occ]
        return bn.pad_limbs(out, n - occ) if occ < n else out

    def negmod(self, a: torch.Tensor) -> torch.Tensor:
        return self.submod(torch.zeros_like(a), a)

    # -- exponentiation -----------------------------------------------------

    def _table16(self, x: torch.Tensor):
        rows = [self.one_like(x), x]
        for _ in range(14):
            rows.append(self._mm(rows[-1], x))
        return rows

    def powmod_const_exp(self, x: torch.Tensor, exponent: int) -> torch.Tensor:
        """x^e mod m for a batch-shared python-int exponent, 4-bit windows."""
        if exponent == 0:
            return self.one_like(x)
        rows = self._table16(x)
        nw = -(-exponent.bit_length() // 4)
        acc = None
        for i in range(nw - 1, -1, -1):
            d = (exponent >> (4 * i)) & 15
            if acc is None:
                acc = rows[d]
                continue
            for _ in range(4):
                acc = self._mm(acc, acc)
            if d:
                acc = self._mm(acc, rows[d])
        return acc

    def powmod(self, x: torch.Tensor, ebits: torch.Tensor) -> torch.Tensor:
        """x^e with per-element exponent bits (LSB-first), 4-bit windows."""
        n = self.prof.n_limbs
        shape = torch.broadcast_shapes(x.shape[:-1], ebits.shape[:-1])
        x = x.expand(shape + (n,))
        digits = _window_digits(ebits, 4).expand(shape + (-1,))
        tbl = torch.stack(self._table16(x), dim=-2)  # (..., 16, n)
        acc = None
        for i in range(digits.shape[-1] - 1, -1, -1):
            idx = digits[..., i, None, None].expand(shape + (1, n))
            sel = tbl.gather(-2, idx).squeeze(-2)
            if acc is None:
                acc = sel
                continue
            for _ in range(4):
                acc = self._mm(acc, acc)
            acc = self._mm(acc, sel)
        return acc

    def powmod_fixed_base(self, base: int, ebits: torch.Tensor) -> torch.Tensor:
        """base^e mod m, python-int base, per-element exponent bits.
        Host-precomputed comb tables base^(2^(w·i) · d): one mulmod per
        w-bit window (w = COMB_W), no squarings."""
        n_bits = ebits.shape[-1]
        wbits = COMB_W
        nw = -(-n_bits // wbits)
        key = (base % self.modulus, nw, wbits)
        tbl = self._fb_tables.get(key)
        if tbl is None:
            m = self.modulus
            rows = 1 << wbits
            vals = []
            b_i = base % m
            for _ in range(nw):
                acc = 1
                for _ in range(rows):
                    vals.append(acc)
                    acc = acc * b_i % m
                b_i = pow(b_i, rows, m)
            tbl = torch.as_tensor(
                ints_to_limbs(vals, self.prof).reshape(nw, rows, self.prof.n_limbs),
                device=self.device,
            )
            self._fb_tables[key] = tbl
        digits = _window_digits(ebits, wbits)
        acc = None
        for i in range(nw):
            sel = tbl[i][digits[..., i]]
            acc = sel if acc is None else self._mm(acc, sel)
        return acc

    def invmod_prime(self, x: torch.Tensor) -> torch.Tensor:
        return self.powmod_const_exp(x, self.modulus - 2)

    # -- batch product reduction (for randomized batch verification) --------

    def prod_over_batch(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Product of x_b mod m along ``axis`` by log-depth pairwise folds."""
        x = torch.movedim(x, axis, 0)
        while x.shape[0] > 1:
            k = x.shape[0]
            if k % 2:
                x = torch.cat([x, self.one_like(x[:1])], dim=0)
                k += 1
            x = self._mm(x[: k // 2], x[k // 2:])
        return x[0]


def _window_digits(ebits: torch.Tensor, w: int) -> torch.Tensor:
    """(..., n_bits) LSB-first bits → (..., ceil(n/w)) w-bit digits, LSD
    first (int64)."""
    n_bits = ebits.shape[-1]
    nw = -(-n_bits // w)
    b = bn.pad_limbs(ebits.to(I64), nw * w - n_bits)
    return (b.reshape(ebits.shape[:-1] + (nw, w)) << bn._arange(w, ebits.device)).sum(-1)
