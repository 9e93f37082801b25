"""Batched prime-field arithmetic for the two curve fields (PyTorch).

The port of ``mpcium_tpu/core/fields.py``. Both primes are
pseudo-Mersenne, p = 2^k - c (secp256k1: k = 256, c = 2^32 + 977;
ed25519: k = 255, c = 19), so limbs above the 264-bit P256 capacity
fold back multiplied by ``c·2^(264-k)`` (2^264 ≡ c·2^(264-k) mod p):
c·2^8 for secp256k1, 19·2^9 for ed25519.

Representation. An element is a (..., 22) float64 tensor of 12-bit-radix
limbs that is only *weakly* normalized: every limb is an integer in
[0, 2^13) and the value is congruent to the element, not reduced.
:meth:`canonical` maps to [0, p) as standard int32 limbs, and every value
that leaves the field (encodings, x-coordinates, equality) goes through
it, so the results are the JAX package's limb for limb.

Why float64: eager PyTorch pays one launch per op, and in float64 a
carry pass is linear algebra. With ``hi = floor(x / 2^12)`` (exact), one
pass is ``x + hi @ M`` where M subtracts 2^12·hi from each limb and adds
it to the next one — and, for the top limb, back into limbs 0..3 times
c·2^8. A product is one outer product, one matmul that already folds
the high columns, two passes, a second fold matmul and two wrapped
passes: fifteen launches. Every intermediate is an integer below 2^53,
so float64 is exact; no value goes through TF32 or bf16.

Bounds of a product (inputs with limbs < 2^13; outer-product entries
< 2^26). secp256k1, fold limbs (256, 61, 0, 16): folded columns <
22·2^26·(1+256+61+16) < 2^39; after two passes limbs < 2^15.2; the
second fold gives columns < 2^23.6; two wrapped passes end below 2^13.
ed25519, fold limbs (1536, 2): folded columns < 22·2^26·(1+1536+2) <
2^41 (the fold lands below column 22, so limbs 22–26 hold only carries);
after two passes limbs < 2^17.1; the second fold gives columns <
2^22.7; the first wrapped pass leaves limb 0 below 2^15.7 and the
second brings every limb below 2^13 (limb 0 at most 4095 + 1536).
Sums and differences wrap once for secp256k1 and twice for ed25519
(``_lin_wraps``). ed25519's top limb holds 3 bits (k = 21·12 + 3):
:meth:`canonical` takes its quotient from the low 3 bits' overflow.
tests/test_torch_curve.py and tests/test_torch_ed25519.py drive
all-ones inputs.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import bignum as bn
from .bignum import F64, I32, I64, P256

PROF = P256
_N = PROF.n_limbs
_BITS = PROF.bits
_MASK = PROF.mask
_R = float(PROF.radix)


def _pass(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """One carry pass: x + floor(x / radix) @ M (exact in float64)."""
    return x + torch.div(x, _R, rounding_mode="floor") @ M


class PseudoMersenneField:
    """F_p for p = 2^k - c on ``device``; weakly normalized elements."""

    def __init__(self, k: int, c: int, device=None):
        assert PROF.capacity_bits >= k
        self.k, self.c = k, c
        self.p = (1 << k) - c
        self.device = torch.device(device) if device is not None else None
        shift = PROF.capacity_bits - k
        self.fold_const = c << shift
        fc = [int(v) for v in bn.to_limbs(
            self.fold_const, PROF, -(-self.fold_const.bit_length() // _BITS)
        )]
        assert len(fc) + 5 < _N
        W = _N + 5  # product width after the first fold
        # outer-product entry (i, j) → column i+j, or folded into i+j-22+t
        W1 = np.zeros((_N * _N, W))
        for i in range(_N):
            for j in range(_N):
                if i + j < _N:
                    W1[i * _N + j, i + j] += 1
                else:
                    for t, f in enumerate(fc):
                        W1[i * _N + j, i + j - _N + t] += f
        # W-limb roll pass that keeps the top limb whole (value exact)
        Mw = np.zeros((W, W))
        for j in range(W - 1):
            Mw[j, j] = -_R
            Mw[j, j + 1] = 1
        # second fold: W limbs → 22 columns
        W2 = np.zeros((W, _N))
        W2[np.arange(_N), np.arange(_N)] = 1
        for j in range(W - _N):
            for t, f in enumerate(fc):
                W2[_N + j, j + t] += f
        # wrapped pass over 22 limbs: the top carry re-enters times c·2^8
        Mr = np.zeros((_N, _N))
        for j in range(_N):
            Mr[j, j] = -_R
            if j + 1 < _N:
                Mr[j, j + 1] = 1
        for t, f in enumerate(fc):
            Mr[_N - 1, t] += f
        dev = self.device
        self._W1, self._Mw, self._W2, self._Mr = (
            torch.as_tensor(a, dtype=F64, device=dev) for a in (W1, Mw, W2, Mr)
        )
        # a multiple of p (p·2^11) spread so that every limb is ≥ 2^13:
        # a + K - b stays limb-wise non-negative for weak inputs
        V = self.p << 11
        std = [(V >> (_BITS * i)) & _MASK for i in range(_N - 1)]
        K = [std[0] + 3 * PROF.radix] + [
            s + 3 * PROF.radix - 3 for s in std[1:]
        ] + [(V >> (_BITS * (_N - 1))) - 3]
        assert sum(v << (_BITS * i) for i, v in enumerate(K)) == V
        assert min(K) >= 1 << 13
        self._K = torch.tensor(K, dtype=F64, device=dev)
        # canonical(): fold constant, 2^264 - p and c as int64 limbs
        self._fcl = torch.tensor(fc, dtype=I64, device=dev)
        self._comp_p = torch.as_tensor(
            bn.to_limbs((1 << (_BITS * _N)) - self.p, PROF, _N + 1),
            dtype=I64, device=dev,
        )
        self._c_limbs = torch.as_tensor(
            bn.to_limbs(c, PROF, -(-c.bit_length() // _BITS)),
            dtype=I64, device=dev,
        )
        self.top_shift = k - (_N - 1) * _BITS
        assert 0 < self.top_shift <= _BITS
        # wrapped passes that bring a + K - b (the largest sum of add, sub
        # and neg) back below 2^13 per limb: one for secp256k1's fold
        # limbs; two for ed25519's, whose low fold limb 1536 takes limb 0
        # to 4095 + 5·1536 after one
        bound = [(1 << 13) - 1 + v for v in K]
        self._lin_wraps = 0
        while max(bound) >= 1 << 13:
            carry = [v >> _BITS for v in bound]
            bound = [_MASK + (carry[j - 1] if j else 0)
                     + (fc[j] * carry[-1] if j < len(fc) else 0) for j in range(_N)]
            self._lin_wraps += 1

    def _wrap(self, x: torch.Tensor, passes: int = 1) -> torch.Tensor:
        for _ in range(passes):
            x = _pass(x, self._Mr)
        return x

    # -- arithmetic (float64 in, float64 out) -------------------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        outer = a.to(F64).unsqueeze(-1) * b.to(F64).unsqueeze(-2)
        x = outer.flatten(-2) @ self._W1  # 27 cols < 2^39
        x = _pass(_pass(x, self._Mw), self._Mw) @ self._W2  # 22 cols < 2^24
        return self._wrap(x, 2)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._wrap(a.to(F64) + b, self._lin_wraps)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._wrap(a.to(F64) + self._K - b, self._lin_wraps)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self._wrap(self._K - a, self._lin_wraps)

    def mul_small(self, a: torch.Tensor, s) -> torch.Tensor:
        """a·s for small factors 0 ≤ s < 32 (python int, or a tensor of
        per-row factors that broadcasts against ``a``)."""
        return self._wrap(a.to(F64) * s, 2)

    # -- canonical form -----------------------------------------------------

    def canonical(self, x: torch.Tensor) -> torch.Tensor:
        """Weak element → int32 standard limbs of its value in [0, p)."""
        y = bn.carry(bn.pad_limbs(x.to(I64), 1), PROF)  # exact, < 2^265.01
        # fold the 2^264 limb: W = lo + t·c·2^8 < 2^264 + 2^42
        y[..., : self._fcl.shape[0]] += y[..., _N:] * self._fcl
        y[..., _N] = 0
        y = bn.carry(y, PROF)
        # q = floor(W / 2^k) < 2^9: W - q·2^k + q·c < 2^k + 2^42 < 2p
        q = (y[..., _N - 1: _N] >> self.top_shift) + (
            y[..., _N:] << (_BITS - self.top_shift)
        )
        y[..., _N - 1] &= (1 << self.top_shift) - 1
        y[..., _N] = 0
        y[..., : self._c_limbs.shape[0]] += q * self._c_limbs
        y = bn.carry(y, PROF)
        u = bn.carry(y + self._comp_p, PROF)  # y - p + 2^264
        return torch.where(u[..., _N:] >= 1, u[..., :_N], y[..., :_N]).to(I32)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.is_zero(self.sub(a, b))

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return torch.all(self.canonical(a) == 0, dim=-1)

    # -- exponentiation -----------------------------------------------------

    def pow_const(self, x: torch.Tensor, exponent: int) -> torch.Tensor:
        """x^e for a python-int exponent (4-bit fixed windows)."""
        if exponent == 0:
            return self.one_like(x)
        x = x.to(F64)
        tbl = [self.one_like(x), x]
        for _ in range(14):
            tbl.append(self.mul(tbl[-1], x))
        nw = -(-exponent.bit_length() // 4)
        acc = None
        for i in range(nw - 1, -1, -1):
            d = (exponent >> (4 * i)) & 15
            if acc is None:
                acc = tbl[d]
                continue
            for _ in range(4):
                acc = self.square(acc)
            if d:
                acc = self.mul(acc, tbl[d])
        return acc

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Batched inverse via Fermat. inv(0) = 0 (callers gate on is_zero)."""
        return self.pow_const(x, self.p - 2)

    # -- helpers ------------------------------------------------------------

    def one_like(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(x.shape[:-1] + (_N,), dtype=F64, device=x.device)
        out[..., 0] = 1
        return out

    def const(self, value: int, batch_shape=()) -> torch.Tensor:
        """value mod p broadcast to ``batch_shape``: a view of the shared
        cached limbs (``bn.const_limbs``), read-only."""
        v = bn.const_limbs(value % self.p, PROF, self.device, F64)
        return v.expand(tuple(batch_shape) + (_N,))

    def to_ints(self, x: torch.Tensor) -> list:
        return bn.batch_from_limbs(self.canonical(x), PROF)

    def from_ints(self, xs) -> np.ndarray:
        return bn.batch_to_limbs([v % self.p for v in xs], PROF)

    def from_limbs(self, x: torch.Tensor) -> torch.Tensor:
        """Standard int limbs (< 2^13 each) → a field element."""
        return x.to(F64)


@functools.lru_cache(maxsize=None)
def ed25519_field(device=None) -> PseudoMersenneField:
    return PseudoMersenneField(k=255, c=19, device=device)


@functools.lru_cache(maxsize=None)
def secp256k1_field(device=None) -> PseudoMersenneField:
    return PseudoMersenneField(k=256, c=(1 << 32) + 977, device=device)


class Secp256k1Sqrt:
    """Square roots in F_p for p ≡ 3 (mod 4): x^((p+1)/4)."""

    def __init__(self, device=None):
        self.F = secp256k1_field(device)

    def sqrt(self, x: torch.Tensor):
        F = self.F
        root = F.pow_const(x, (F.p + 1) // 4)
        ok = F.eq(F.square(root), x)
        return root, ok
