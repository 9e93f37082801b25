"""Batched multi-word integer arithmetic on limb tensors (PyTorch).

The port of ``mpcium_tpu/core/bignum.py``. A big integer is a
little-endian vector of ``n_limbs`` limbs of ``bits`` bits, shape
(..., n_limbs), with any leading batch shape. Tensors at rest are int32,
as in the JAX package, so the two packages compare limb for limb.

What differs from the JAX code is how the work is cut into tensor ops,
because eager PyTorch pays one launch per op:

* **Carries take a fixed handful of ops.** A bias of t·radix^n (≡ 0)
  makes every limb non-negative, a few shift-and-add roll passes bring
  limbs to at most 2·radix - 2, and the remaining 0/1 carry chain is
  resolved by one ``cummax`` carry-lookahead (:func:`lookahead`).
  Negative limbs are allowed, as ``bignum.carry`` allows them.
* **Products contract in float64.** torch has no integer matmul on CUDA
  and a bf16 matmul rounds its sums; every column sum here stays below
  2^53, so float64 is exact. No integer payload goes through bf16 or
  TF32.
* **Compares take no scan:** the most significant differing limb is
  found with one ``amax`` over the limb index.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64


@dataclass(frozen=True)
class LimbProfile:
    """Static limb layout: ``n_limbs`` limbs of ``bits`` bits."""

    bits: int
    n_limbs: int

    @property
    def radix(self) -> int:
        return 1 << self.bits

    @property
    def mask(self) -> int:
        return self.radix - 1

    @property
    def capacity_bits(self) -> int:
        return self.bits * self.n_limbs

    def __post_init__(self):
        assert self.n_limbs * (self.radix - 1) ** 2 < 2**31, (
            "limb profile overflows int32 accumulation"
        )


# 264-bit capacity: the secp256k1 field and scalar ring
P256 = LimbProfile(bits=12, n_limbs=22)


# ---------------------------------------------------------------------------
# host <-> limb conversion
# ---------------------------------------------------------------------------


def to_limbs(x: int, prof: LimbProfile, n_limbs: Optional[int] = None) -> np.ndarray:
    n = n_limbs or prof.n_limbs
    assert 0 <= x < 1 << (prof.bits * n), "value exceeds limb capacity"
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & prof.mask
        x >>= prof.bits
    return out


def from_limbs(limbs, prof: LimbProfile) -> int:
    arr = np.asarray(limbs)
    assert arr.ndim == 1, "from_limbs is host-side, single value"
    acc = 0
    for i in range(arr.shape[0] - 1, -1, -1):
        acc = (acc << prof.bits) + int(arr[i])
    return acc


def batch_to_limbs(xs, prof: LimbProfile, n_limbs: Optional[int] = None) -> np.ndarray:
    """Python ints → (len, n) int32 limbs, by byte packing (numpy speed)."""
    n = n_limbs or prof.n_limbs
    xs = [int(v) for v in xs]
    if not xs:
        return np.zeros((0, n), np.int32)
    cap = prof.bits * n
    assert min(xs) >= 0 and max(xs).bit_length() <= cap, "value exceeds limb capacity"
    nbytes = -(-cap // 8)
    raw = np.frombuffer(
        b"".join(v.to_bytes(nbytes, "little") for v in xs), dtype=np.uint8
    ).reshape(len(xs), nbytes)
    bits = np.unpackbits(raw, axis=-1, bitorder="little")[:, :cap]
    # each limb's bits packed back little-endian: 1 byte (7-bit) or 2 (12-bit)
    packed = np.packbits(bits.reshape(len(xs), n, prof.bits), axis=-1, bitorder="little")
    out = packed[..., 0].astype(np.int32)
    for k in range(1, packed.shape[-1]):
        out |= packed[..., k].astype(np.int32) << (8 * k)
    return out


def batch_from_limbs(arr, prof: LimbProfile) -> list:
    a = limbs_to_numpy(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
    flat = a.reshape(-1, a.shape[-1])
    return [from_limbs(row, prof) for row in flat]


def limbs_from_numpy(arr, device) -> torch.Tensor:
    """numpy limbs (e.g. a JAX array via ``np.asarray``) → int32 tensor."""
    return torch.as_tensor(np.asarray(arr, dtype=np.int32), device=device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Limb tensor → host int32 numpy array (the JAX package's layout)."""
    return t.detach().to("cpu", I32).numpy()


# ---------------------------------------------------------------------------
# cached per-device constants
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=I64, device=device)


@functools.lru_cache(maxsize=None)
def const_limbs(value: int, prof: LimbProfile, device, dtype=I32) -> torch.Tensor:
    """The limbs of ``value`` as a tensor on ``device``, uploaded once per
    (value, profile, device, dtype) and shared by every caller: never
    write to it (clone first). A per-call upload from host memory would
    synchronise the stream, which a CUDA graph capture forbids."""
    return torch.as_tensor(to_limbs(value, prof), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _conv_tensor(n_a: int, n_b: int) -> np.ndarray:
    """One-hot (n_a, n_b, n_a+n_b-1) tensor M with M[i,j,i+j] = 1."""
    m = np.zeros((n_a, n_b, n_a + n_b - 1), dtype=np.int32)
    for i in range(n_a):
        for j in range(n_b):
            m[i, j, i + j] = 1
    return m


@functools.lru_cache(maxsize=None)
def _conv_matrix(n_a: int, n_b: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        _conv_tensor(n_a, n_b).reshape(n_a * n_b, n_a + n_b - 1),
        dtype=F64, device=device,
    )


def toeplitz_np(c_limbs, n_in: int) -> np.ndarray:
    """(n_in, n_in + len(c) - 1) band matrix T[i, i+j] = c[j]."""
    m = len(c_limbs)
    T = np.zeros((n_in, n_in + m - 1), dtype=np.float64)
    for j, cj in enumerate(c_limbs):
        if cj:
            T[np.arange(n_in), np.arange(n_in) + j] = float(cj)
    return T


# ---------------------------------------------------------------------------
# carries / add / compare
# ---------------------------------------------------------------------------


def _roll(x: torch.Tensor, bits: int, mask: int) -> torch.Tensor:
    """One shift-and-add pass: keeps the value mod radix^n, shrinks limbs."""
    return (x & mask) + torch.nn.functional.pad((x >> bits)[..., :-1], (1, 0))


def lookahead(g: torch.Tensor, p: torch.Tensor, cin: int) -> torch.Tensor:
    """Carry INTO each limb from 0/1 generate and propagate flags, with
    carry-in ``cin`` at limb 0. Limbs never both generate and propagate.

    The carry into limb j is decided by the nearest limb below j that
    does not propagate: 1 if it generates, 0 if it kills, ``cin`` if
    there is none. One ``cummax`` over the limb index finds that limb
    for every j at once, so the chain costs five ops at any width.
    """
    n = g.shape[-1]
    idx = _arange(n, g.device, 1)
    last = torch.cummax(torch.where(p.bool(), 0, idx), dim=-1).values
    src = torch.nn.functional.pad(last[..., :-1], (1, 0))  # over limbs < j
    return torch.nn.functional.pad(g, (1, 0), value=cin).gather(-1, src)


@functools.lru_cache(maxsize=None)
def _carry_plan(n: int, bits: int, in_bits: int, signed: bool, device: torch.device):
    """Bias and pass count for :func:`carry` on limbs in
    (-2^in_bits, 2^in_bits) (or [0, 2^in_bits) unsigned). The bias adds
    t·(radix^n - 1) + t = t·radix^n (≡ 0 mod radix^n) with t·mask ≥
    2^in_bits, so every limb is non-negative; roll passes then bring
    limbs to at most 2·radix - 2."""
    R = 1 << bits
    t = -(-(1 << in_bits) // (R - 1)) if signed else 0
    bias = None
    if t:
        bias = torch.full((n,), t * (R - 1), dtype=I64, device=device)
        bias[0] += t
    pos, k = (1 << in_bits) + t * R, 0
    while pos > 2 * R - 2:
        pos = R - 1 + pos // R
        k += 1
    return bias, k


def carry(x: torch.Tensor, prof: LimbProfile, in_bits: int = 31,
          signed: bool = True) -> torch.Tensor:
    """Full carry propagation → normalized limbs, same shape and dtype.

    Valid for any limb values in (-2^in_bits, 2^in_bits), negative ones
    included (``signed=False`` promises non-negative limbs and skips the
    bias); a carry out of the top limb is dropped (mod radix^n), as in
    the JAX package.
    """
    dt = x.dtype
    bits, mask = prof.bits, prof.mask
    bias, passes = _carry_plan(x.shape[-1], bits, in_bits, signed, x.device)
    x = x.to(I64)
    if bias is not None:
        x = x + bias
    for _ in range(passes):
        x = _roll(x, bits, mask)
    # limbs in [0, 2·radix - 2]: a limb that generates has remainder at
    # most radix - 2, so generate and propagate (remainder == mask) never
    # coincide and every carry stays 0/1
    r = x & mask
    c = lookahead(x >> bits, r == mask, 0)
    return ((r + c) & mask).to(dt)


def compare(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Lexicographic compare of normalized values: -1 / 0 / +1 (int64)."""
    x, y = torch.broadcast_tensors(x.to(I64), y.to(I64))
    d = torch.sign(x - y)
    n = d.shape[-1]
    top = ((d != 0) * _arange(n, d.device, 1)).amax(-1, keepdim=True)
    # all-equal rows gather d[..., 0] == 0
    return d.gather(-1, (top - 1).clamp(min=0)).squeeze(-1)


def cond_sub(x: torch.Tensor, m: torch.Tensor, prof: LimbProfile) -> torch.Tensor:
    """If x ≥ m: x - m, else x. Normalized in/out, same width."""
    ge = compare(x, m) >= 0
    return torch.where(ge[..., None], carry(x - m, prof), x)


def pad_limbs(x: torch.Tensor, extra: int) -> torch.Tensor:
    """Append ``extra`` zero limbs at the most-significant end."""
    if extra == 0:
        return x
    return torch.nn.functional.pad(x, (0, extra))


def shift_limbs(x: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by radix^k (prepend k zero limbs at the little end)."""
    return torch.nn.functional.pad(x, (k, 0))


def take_limbs(x: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Limbs [start, start+count), zero-padded past the top."""
    n = x.shape[-1]
    if start >= n:
        return torch.zeros(x.shape[:-1] + (count,), dtype=x.dtype, device=x.device)
    sl = x[..., start: min(n, start + count)]
    return pad_limbs(sl, count - sl.shape[-1])


# ---------------------------------------------------------------------------
# byte/bit packing (wire format <-> limbs on the device)
# ---------------------------------------------------------------------------


def _bits_to_groups(bits: torch.Tensor, width: int, n_groups: int) -> torch.Tensor:
    """(..., nbits) 0/1 → (..., n_groups) values of ``width`` bits each
    (zero-extended or truncated)."""
    want = n_groups * width
    have = bits.shape[-1]
    bits = pad_limbs(bits, want - have) if have < want else bits[..., :want]
    groups = bits.reshape(bits.shape[:-1] + (n_groups, width))
    return (groups << _arange(width, bits.device)).sum(-1)


def _to_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """(..., k) values of ``width`` bits → (..., k·width) bits LSB-first."""
    b = (x.to(I64).unsqueeze(-1) >> _arange(width, x.device)) & 1
    return b.reshape(x.shape[:-1] + (x.shape[-1] * width,))


def bytes_to_limbs_le(b: torch.Tensor, prof: LimbProfile, n_limbs: int) -> torch.Tensor:
    """(..., n_bytes) uint8 little-endian → (..., n_limbs) normalized limbs."""
    return _bits_to_groups(_to_bits(b, 8), prof.bits, n_limbs).to(I32)


def limbs_to_bytes_le(x: torch.Tensor, prof: LimbProfile, n_bytes: int) -> torch.Tensor:
    """Normalized limbs → (..., n_bytes) uint8 little-endian."""
    return _bits_to_groups(_to_bits(x, prof.bits), 8, n_bytes).to(torch.uint8)


def limbs_to_bits(x: torch.Tensor, prof: LimbProfile, n_bits: int) -> torch.Tensor:
    """Normalized limbs → (..., n_bits) int32 bits, LSB first."""
    bits = _to_bits(x, prof.bits)
    have = bits.shape[-1]
    bits = pad_limbs(bits, n_bits - have) if have < n_bits else bits[..., :n_bits]
    return bits.to(I32)


# ---------------------------------------------------------------------------
# multiplication
# ---------------------------------------------------------------------------

_BLOCK = 32


def columns(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact schoolbook column sums Σ_{i+j=c} x_i·y_j → (..., n_x+n_y-1)
    int64, contracted in float64 (exact while every sum < 2^53)."""
    n_x, n_y = x.shape[-1], y.shape[-1]
    xf, yf = x.to(F64), y.to(F64)
    if n_x * n_y <= 4096:
        outer = xf.unsqueeze(-1) * yf.unsqueeze(-2)
        flat = outer.reshape(outer.shape[:-2] + (n_x * n_y,))
        return (flat @ _conv_matrix(n_x, n_y, x.device)).to(I64)
    rows = max(xf[..., 0].numel(), yf[..., 0].numel())
    if rows * n_x * n_y <= 1 << 16:
        return _columns_skewed(xf, yf).to(I64)
    return _columns_blocked(xf, yf).to(I64)


def _columns_skewed(xf: torch.Tensor, yf: torch.Tensor) -> torch.Tensor:
    """Column sums by skewing the outer product: padded to rows of
    n_x + n_y and re-read with a row stride one shorter, row i lands
    shifted right by i, so a sum over rows gives the columns."""
    n_x, n_y = xf.shape[-1], yf.shape[-1]
    w = n_x + n_y
    outer = torch.nn.functional.pad(xf.unsqueeze(-1) * yf.unsqueeze(-2), (0, n_x))
    flat = outer.flatten(-2)[..., : n_x * (w - 1)]
    return flat.reshape(flat.shape[:-1] + (n_x, w - 1)).sum(-2)


@functools.lru_cache(maxsize=None)
def _band_index_mask(device: torch.device):
    """band[i, c] = block[c - i] for 0 <= c-i < 32 else 0."""
    i = np.arange(_BLOCK)[:, None]
    c = np.arange(2 * _BLOCK - 1)[None, :]
    d = c - i
    ok = (d >= 0) & (d < _BLOCK)
    return (
        torch.as_tensor(np.clip(d, 0, _BLOCK - 1), dtype=I64, device=device),
        torch.as_tensor(ok, dtype=F64, device=device),
    )


@functools.lru_cache(maxsize=None)
def _block_conv(bx: int, by: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_conv_tensor(bx, by), dtype=F64, device=device)


def _columns_blocked(xf: torch.Tensor, yf: torch.Tensor) -> torch.Tensor:
    """Wide column sums: 32-limb blocks, the Toeplitz band of each y block
    contracted against the x blocks, then overlap-add (all float64)."""
    n_x, n_y = xf.shape[-1], yf.shape[-1]
    bx, by = -(-n_x // _BLOCK), -(-n_y // _BLOCK)
    xb = pad_limbs(xf, bx * _BLOCK - n_x).reshape(xf.shape[:-1] + (bx, _BLOCK))
    yb = pad_limbs(yf, by * _BLOCK - n_y).reshape(yf.shape[:-1] + (by, _BLOCK))
    idx, mask = _band_index_mask(xf.device)
    band = yb[..., idx] * mask  # (..., by, 32, 63): band[v, i, c] = y_v[c-i]
    prods = torch.einsum("...ui,...vic->...uvc", xb, band)
    bt = bx + by - 1
    blk = _block_conv(bx, by, xf.device)
    lo = torch.einsum("...uvc,uvt->...tc", prods[..., :_BLOCK], blk)
    hi = torch.einsum("...uvc,uvt->...tc", prods[..., _BLOCK:], blk)
    hi = pad_limbs(hi, 1)
    lo_flat = pad_limbs(lo.reshape(lo.shape[:-2] + (bt * _BLOCK,)), _BLOCK)
    hi_flat = shift_limbs(hi.reshape(hi.shape[:-2] + (bt * _BLOCK,)), _BLOCK)
    return (lo_flat + hi_flat)[..., : n_x + n_y - 1]


def _col_bits(n_x: int, n_y: int, prof: LimbProfile) -> int:
    return (min(n_x, n_y) * prof.mask * prof.mask).bit_length() + 1


def mul(x: torch.Tensor, y: torch.Tensor, prof: LimbProfile) -> torch.Tensor:
    """Schoolbook product → normalized (..., n_x + n_y) limbs."""
    n_x, n_y = x.shape[-1], y.shape[-1]
    cols = pad_limbs(columns(x, y), 1)
    return carry(cols, prof, _col_bits(n_x, n_y, prof)).to(I32)


def mul_wide(x: torch.Tensor, y: torch.Tensor, prof: LimbProfile) -> torch.Tensor:
    """Product of wide operands → normalized (..., n_x + n_y) limbs (the
    same value as :func:`mul`; blocked contraction inside)."""
    return mul(x, y, prof)


# ---------------------------------------------------------------------------
# Barrett reduction (generic modulus)
# ---------------------------------------------------------------------------


class BarrettCtx:
    """Barrett context for a fixed modulus m with radix^(n-1) ≤ m <
    radix^n (HAC Alg. 14.42), on ``device``. The curve scalar ring.

    ``reduce`` maps normalized x < radix^(2n) to x mod m; the two
    constant products ride float64 Toeplitz matmuls, and both trailing
    conditional subtractions add the radix complement of m and read the
    top limb instead of comparing.
    """

    def __init__(self, modulus: int, prof: LimbProfile = P256, device=None):
        n = prof.n_limbs
        assert prof.radix ** (n - 1) <= modulus < prof.radix**n, (
            "modulus must occupy the top limb for Barrett"
        )
        self.prof = prof
        self.modulus = modulus
        self.device = torch.device(device) if device is not None else None
        dev = self.device
        self.m_limbs = to_limbs(modulus, prof)
        self.m_limbs_p1 = to_limbs(modulus, prof, n_limbs=n + 1)
        mu = (1 << (2 * n * prof.bits)) // modulus
        self.mu_limbs = to_limbs(mu, prof, n_limbs=n + 2)
        self._T_mu = torch.as_tensor(
            toeplitz_np(self.mu_limbs, n + 1), dtype=F64, device=dev
        )
        self._T_m = torch.as_tensor(
            toeplitz_np(self.m_limbs, n + 1)[:, : n + 1], dtype=F64, device=dev
        )
        comp = (1 << ((n + 1) * prof.bits)) - modulus
        self._comp = torch.as_tensor(
            to_limbs(comp, prof, n_limbs=n + 2), dtype=I64, device=dev
        )
        self._m1 = torch.as_tensor(self.m_limbs_p1, dtype=I64, device=dev)
        self._in_bits = _col_bits(n + 2, n + 2, prof)

    def _cond_sub(self, r: torch.Tensor) -> torch.Tensor:
        """r < 2m over n+1 limbs → r mod m (complement add, top-limb test)."""
        n = self.prof.n_limbs
        u = carry(pad_limbs(r, 1) + self._comp, self.prof)
        return torch.where(u[..., n + 1: n + 2] >= 1, u[..., : n + 1], r)

    # -- core ---------------------------------------------------------------

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x (normalized, any width ≤ 2n limbs) → x mod m (n limbs)."""
        prof, n = self.prof, self.prof.n_limbs
        q1 = take_limbs(x, n - 1, n + 1).to(F64)
        q2 = carry((q1 @ self._T_mu).to(I64), prof, self._in_bits)
        q3 = q2[..., n + 1: 2 * n + 2].to(F64)
        # low n+1 columns of q3·m: higher columns only add multiples of
        # radix^(n+1), which the final slice drops (carry works mod
        # radix^(n+2), so the difference may go negative there)
        q3m = (q3 @ self._T_m).to(I64)
        t = pad_limbs(take_limbs(x, 0, n + 1).to(I64) - q3m, 1)
        r = carry(t, prof, self._in_bits)[..., : n + 1]
        r = self._cond_sub(self._cond_sub(r))
        return r[..., :n].to(I32)

    # -- ring ops -----------------------------------------------------------

    def mulmod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.reduce(mul(a, b, self.prof))

    def addmod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        n = self.prof.n_limbs
        s = carry(pad_limbs(a.to(I64) + b.to(I64), 1), self.prof)  # < 2m
        return self._cond_sub(s)[..., :n].to(I32)

    def submod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        n = self.prof.n_limbs
        d = carry(
            self._m1 + pad_limbs(a.to(I64), 1) - pad_limbs(b.to(I64), 1),
            self.prof,
        )  # a - b + m in (0, 2m)
        return self._cond_sub(d)[..., :n].to(I32)

    def negmod(self, a: torch.Tensor) -> torch.Tensor:
        return self.submod(torch.zeros_like(a), a)

    def powmod_const(self, x: torch.Tensor, exponent: int) -> torch.Tensor:
        """x^e mod m for a python-int exponent ≥ 0 (4-bit fixed windows:
        the same value as the JAX bit-serial ladder, fewer multiplies)."""
        if exponent == 0:
            return self.one_like(x)
        tbl = [self.one_like(x), x]
        for _ in range(14):
            tbl.append(self.mulmod(tbl[-1], x))
        nw = -(-exponent.bit_length() // 4)
        acc = None
        for i in range(nw - 1, -1, -1):
            d = (exponent >> (4 * i)) & 15
            if acc is None:
                acc = tbl[d]
                continue
            for _ in range(4):
                acc = self.mulmod(acc, acc)
            if d:
                acc = self.mulmod(acc, tbl[d])
        return acc

    def invmod_prime(self, x: torch.Tensor) -> torch.Tensor:
        """Batched modular inverse via Fermat — prime modulus only."""
        return self.powmod_const(x, self.modulus - 2)

    # -- helpers ------------------------------------------------------------

    def one_like(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(
            x.shape[:-1] + (self.prof.n_limbs,), dtype=I32, device=x.device
        )
        out[..., 0] = 1
        return out

    def const(self, value: int, batch_shape=()) -> torch.Tensor:
        """value mod m broadcast to ``batch_shape``: a view of the shared
        cached limbs (:func:`const_limbs`), read-only."""
        v = const_limbs(value % self.modulus, self.prof, self.device)
        return v.expand(tuple(batch_shape) + (self.prof.n_limbs,))
