"""Batched a·b mod m and whole exponentiations: the hand-written CUDA
kernels and their plain versions.

Replaces the TPU kernel ``mpcium_tpu/ops/pallas_mulmod.py:_mulmod_kernel``
(the only ``pallas_call`` in the JAX package) and the exponent loops
around it. Two entries, both in ``csrc/mulmod.cu``:

* :func:`mulmod` — one product per row, the counterpart of
  ``mpcium_tpu/ops/modmul._mm``. ``MXUBarrett.mulmod`` and
  ``prod_over_batch`` come here.
* :func:`powmod` — one whole exponentiation per row in one launch, the
  counterpart of ``_k_powmod`` (mode ``"row"``: per-row exponent),
  ``_k_powmod_digits`` (``"shared"``: one exponent for the batch) and
  ``_k_powmod_fb`` (``"comb"``: fixed-base comb table). The row stays in
  registers for the whole loop.

A CUDA tensor launches the kernel (or raises), a CPU tensor takes the
plain version (:func:`mulmod_plain`, :func:`powmod_plain`). There is no
switch and no fallback.

Both versions take normalized (..., n) limbs. The plain versions are
exact where the JAX kernel is, for a·b < R^occ·m (operands above m
included); the kernels are exact for every normalized n-limb operand,
so the two agree bit for bit wherever the JAX kernel is defined, and
every result is the canonical residue whatever the window schedule.

What bounds the kernels on an H100 is 32-bit integer multiply-add
issue, not bytes (~7.5 MB in and out per 4096-bit product at B=1024
against ~34 M word products), with ~8 rows an SM to hide latency. So a
row lives on one warp, W = ceil(k/32) words a lane, and each step is a
Montgomery product in radix 2^32 whose carries stay pending per lane
and are resolved once by a warp-parallel carry lookahead (see the
source note in ``csrc/mulmod.cu``). The kernels need
an odd modulus, as every one the signing path gives them is: for an even
one they raise ``ValueError`` and the plain version still runs. The
reduction on tensor cores is later work.

The library is compiled with ``nvcc`` into ``build/mpcium_tpu_torch/``
at the first CUDA call and bound with ctypes (plain C interface, no
PyTorch headers). Each process's build is one entry of the compile ledger
(``perf/compile_watch``): ``cache`` ``hit`` when the library of that
source digest already existed.

Counters: ``launches`` counts launches of the single-product kernel,
``launches_by_width`` the same per limb width n;
``powmod_launches_by_mode_width`` counts powmod launches per
(mode, n); ``plain_calls`` counts calls of either plain version. They
are updated under one lock, so parties on concurrent threads count
exactly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..perf import compile_watch

LIMB_BITS = 7
MAX_LIMBS = 608  # 4256 bits: the 4096-bit Paillier N² width
_KMAX, _WMAX = 136, 5  # csrc/mulmod.cu: words of the widest row, words a lane

POWMOD_MODES = ("row", "shared", "comb")  # csrc/mulmod.cu MODE_ROW, ...
COMB_ROWS = 256  # entries per comb window: 8-bit digits
COMB_MAX_WINDOWS = MAX_LIMBS * LIMB_BITS // 8  # the kernel's widest comb: a 4256-bit exponent

launches = 0
launches_by_width: Dict[int, int] = {}
powmod_launches_by_mode_width: Dict[Tuple[str, int], int] = {}
plain_calls = 0

SRC = Path(__file__).resolve().parent / "csrc" / "mulmod.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mpcium_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# the counters are bumped from every thread that runs a party (the nodes
# of an in-process cluster sign concurrently): a bare += can lose counts
_count_lock = threading.Lock()
build_log = ""


def reset_counters() -> None:
    global launches, plain_calls
    with _count_lock:
        launches = 0
        plain_calls = 0
        launches_by_width.clear()
        powmod_launches_by_mode_width.clear()


@dataclass(frozen=True)
class MulmodConsts:
    """Per-modulus operands, built once by ``MXUBarrett``: the Toeplitz
    constants of the plain (7-bit Barrett) version and the kernel's
    Montgomery constants. The kernel holds a row in s = 32·w words, w =
    ceil(k/32) words a lane (k words of m), and works with R = 2^(32s);
    a row of n limbs spans kw = ceil(7n/32) words. ``mont_words`` (3, s):
    m, 2^(64kw) mod m (the product's entry) and 2^(32(kw+s)) mod m (the
    exponentiation's entry, x·R); ``mprime`` = -m^-1 mod 2^32. An even
    modulus has no Montgomery form: its words and ``mprime`` are zero and
    the kernels raise. ``exit_words`` (COMB_MAX_WINDOWS + 1, s) holds
    R^j mod m, j = 0, 1, ...: a comb of nz non-zero digits makes nz-1
    Montgomery products of canonical entries, each leaving a factor
    R^-1, and ends with one product by R^nz."""

    modulus: int
    occ: int
    n: int
    T_mu: torch.Tensor
    T_m: torch.Tensor
    comps: torch.Tensor
    k: int
    kw: int
    w: int
    mprime: int
    mont_words: torch.Tensor
    exit_words: torch.Tensor

    @property
    def s(self) -> int:
        return 32 * self.w


def ints_to_words(vals, count: int) -> np.ndarray:
    """Non-negative python ints below 2^(32·count) -> (len, count) int32
    arrays of their little-endian 32-bit words (bit patterns of uint32)."""
    buf = b"".join(v.to_bytes(4 * count, "little") for v in vals)
    return np.frombuffer(buf, dtype="<i4").reshape(len(vals), count).copy()


def make_consts(modulus: int, occ: int, n: int, T_mu, T_m, comps, device) -> MulmodConsts:
    k = -(-modulus.bit_length() // 32)
    kw = -(-(LIMB_BITS * n) // 32)
    w = -(-k // 32)
    s = 32 * w
    exits = [0] * (COMB_MAX_WINDOWS + 1)
    if modulus & 1:
        mprime = -pow(modulus, -1, 1 << 32) % (1 << 32)
        vals = [modulus, (1 << (64 * kw)) % modulus, (1 << (32 * (kw + s))) % modulus]
        R, v = (1 << (32 * s)) % modulus, 1 % modulus
        for j in range(len(exits)):
            exits[j], v = v, v * R % modulus
    else:
        mprime, vals = 0, [0, 0, 0]
    return MulmodConsts(
        modulus, occ, n, T_mu, T_m, comps, k, kw, w, mprime,
        torch.as_tensor(ints_to_words(vals, s), device=device),
        torch.as_tensor(ints_to_words(exits, s), device=device),
    )


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the mulmod kernel needs the CUDA toolkit")
    return path


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(
            SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = BUILD_DIR / f"libmulmod_{digest}.so"
        # the compile ledger: one entry per process, "hit" when a library
        # of this digest was already built (by another process or run)
        token = compile_watch.begin("mulmod", digest, arch="sm_90a")
        cache = "hit" if so.exists() else "miss"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC)],
                capture_output=True, text=True,
            )
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SRC.name}:\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.mpcium_mulmod
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_uint32] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.mpcium_powmod
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_uint32] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
        compile_watch.finish(token, cache)
        return lib


# ---------------------------------------------------------------------------
# the wrapper and its plain version
# ---------------------------------------------------------------------------


def mulmod(a: torch.Tensor, b: torch.Tensor, c: MulmodConsts) -> torch.Tensor:
    """a·b mod m on normalized (..., n) int32 limbs (broadcastable).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mulmod_plain(a, b, c)
    return mulmod_cuda(a, b, c)


def _check_kernel(c: MulmodConsts, entry: str) -> None:
    if not c.modulus & 1:
        raise ValueError(f"{entry} kernel: the modulus is even; Montgomery needs an odd one")
    if c.n > MAX_LIMBS or c.kw > _KMAX or c.w > _WMAX:
        raise ValueError(f"{entry} kernel: width {c.n} limbs exceeds {MAX_LIMBS}")


def mulmod_cuda(a: torch.Tensor, b: torch.Tensor, c: MulmodConsts) -> torch.Tensor:
    global launches
    n = c.n
    dev = c.mont_words.device
    _check_kernel(c, "mulmod")
    for t in (a, b):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"mulmod kernel: tensor on {t.device}, consts on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"mulmod kernel takes int32 limbs, got {t.dtype}")
        if t.shape[-1] != n:
            raise ValueError(f"mulmod kernel: width {t.shape[-1]} != {n}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a2 = a.expand(shape).reshape(-1, n).contiguous()
    b2 = b.expand(shape).reshape(-1, n).contiguous()
    rows = a2.shape[0]
    out = torch.empty_like(a2)
    if rows == 0:
        return out.reshape(shape)
    lib = build()
    # the C entry launches on the current device: make it the tensors' one
    with torch.cuda.device(dev):
        rc = lib.mpcium_mulmod(
            a2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            c.mont_words.data_ptr(), c.mprime, rows, n, c.k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"mulmod kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
        launches_by_width[n] = launches_by_width.get(n, 0) + 1
    return out.reshape(shape)


def mulmod_plain(a: torch.Tensor, b: torch.Tensor, c: MulmodConsts) -> torch.Tensor:
    """The plain PyTorch version: float64 band product, lookahead carries
    and the Barrett reduction of ``modmul._reduce_impl`` (7-bit radix)."""
    global plain_calls
    with _count_lock:
        plain_calls += 1
    return _mulmod_plain(a, b, c)


def _mulmod_plain(a: torch.Tensor, b: torch.Tensor, c: MulmodConsts) -> torch.Tensor:
    from .modmul import _reduce_impl, mul_pair

    return _reduce_impl(mul_pair(a, b), c.T_mu, c.T_m, c.comps, c.occ, c.n)


# ---------------------------------------------------------------------------
# whole exponentiations: the wrapper and its plain version
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CombTable:
    """Fixed-base comb table, entry [i, d] = base^(2^(8i)·d) mod m for
    d < 256, in both forms: ``limbs`` (nw, 256, n) 7-bit limbs for the
    plain version, ``words`` (nw, 256, k) canonical 32-bit words (int32
    bit patterns) for the kernel."""

    limbs: torch.Tensor
    words: torch.Tensor


def make_comb_table(vals, nw: int, c: MulmodConsts, prof, device) -> CombTable:
    """The comb table from its nw·256 canonical python-int entries."""
    from .modmul import ints_to_limbs

    return CombTable(
        torch.as_tensor(
            ints_to_limbs(vals, prof).reshape(nw, COMB_ROWS, c.n), device=device
        ),
        torch.as_tensor(
            ints_to_words(vals, c.k).reshape(nw, COMB_ROWS, c.k), device=device
        ),
    )


@dataclass(frozen=True)
class PowmodLaunch:
    """What the powmod kernel receives for one call."""

    mode: str
    shape: Tuple[int, ...]  # leading shape of the result
    x: Optional[torch.Tensor]  # (rows, n) int32 limbs; None for "comb"
    digits: torch.Tensor  # int32: (rows, nwin), or (nwin,) for "shared"
    stride: int  # the digits' row stride: nwin, or 0 for "shared"
    table: Optional[torch.Tensor]  # comb words (nw, 256, k); else None

    @property
    def rows(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nwin(self) -> int:
        return self.digits.shape[-1]


def pack_powmod(x, digits: torch.Tensor, c: MulmodConsts, mode: str,
                table: Optional[CombTable] = None) -> PowmodLaunch:
    """Flatten and broadcast the operands of :func:`powmod` into the
    contiguous int32 rows the kernel reads (any device)."""
    n = c.n
    if mode not in POWMOD_MODES:
        raise ValueError(f"powmod: mode {mode!r} not in {POWMOD_MODES}")
    if (mode == "comb") != (x is None) or (mode == "comb") != (table is not None):
        raise ValueError("powmod: mode 'comb' takes a table and no base, the others a base")
    if x is not None:
        if x.dtype != torch.int32:
            raise TypeError(f"powmod takes int32 limbs, got {x.dtype}")
        if x.shape[-1] != n:
            raise ValueError(f"powmod: width {x.shape[-1]} != {n}")
    nwin = digits.shape[-1]  # mpcflow: declassified — the window count, a width
    tw = None
    if mode == "comb":
        tw = table.words
        if tuple(tw.shape[1:]) != (COMB_ROWS, c.k) or nwin > tw.shape[0]:
            raise ValueError(f"powmod: {nwin} comb windows vs table {tuple(tw.shape)}")
        shape = tuple(digits.shape[:-1])
        xs, d = None, digits.reshape(-1, nwin)
    elif mode == "shared":
        if digits.dim() != 1:
            raise ValueError("powmod: mode 'shared' takes one (nwin,) digit array")
        shape = tuple(x.shape[:-1])
        xs, d = x.reshape(-1, n), digits
    else:
        shape = tuple(torch.broadcast_shapes(x.shape[:-1], digits.shape[:-1]))
        xs = x.expand(shape + (n,)).reshape(-1, n)
        d = digits.expand(shape + (nwin,)).reshape(-1, nwin)
    return PowmodLaunch(
        mode, shape, None if xs is None else xs.contiguous(),
        d.to(torch.int32).contiguous(), 0 if mode == "shared" else nwin, tw,
    )


def powmod_steps(L: PowmodLaunch) -> np.ndarray:
    """Modular multiplies (squarings included) the kernel runs per row,
    from the digits: a 15-step window table (x mod m, then x^2..x^15) and
    4 squarings plus one multiply per non-zero digit for every window
    below the top non-zero one; the comb one multiply per non-zero digit
    past the first. e = 0 takes no step. Not counted: the one product
    that leaves Montgomery form (by 1, or by R^nz for the comb)."""
    d = L.digits.cpu().numpy().reshape(-1, L.nwin)
    nz = d != 0
    if L.mode == "comb":
        steps = np.maximum(nz.sum(-1) - 1, 0)
    else:
        top = np.where(nz.any(-1), L.nwin - 1 - np.argmax(nz[:, ::-1], -1), -1)
        below = np.cumsum(nz, -1)[np.arange(len(d)), np.maximum(top, 0)] - nz.any(-1)
        steps = np.where(top >= 0, 15 + 4 * top + below, 0)
    return np.broadcast_to(steps, (L.rows,)) if L.mode == "shared" else steps


def powmod(x, digits: torch.Tensor, c: MulmodConsts, mode: str,
           table: Optional[CombTable] = None) -> torch.Tensor:
    """x^e mod m per row from window digits (least significant first):
    ``"row"``: x (..., n) and 4-bit digits (..., nwin), broadcast;
    ``"shared"``: x (..., n) and one (nwin,) 4-bit digit array;
    ``"comb"``: x None, 8-bit digits (..., nwin) into ``table``.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    lead = digits if x is None else x
    if lead.device.type == "cpu" and digits.device.type == "cpu":
        return powmod_plain(x, digits, c, mode, table)
    return powmod_cuda(x, digits, c, mode, table)


def powmod_cuda(x, digits: torch.Tensor, c: MulmodConsts, mode: str,
                table: Optional[CombTable] = None) -> torch.Tensor:
    n = c.n
    dev = c.mont_words.device
    _check_kernel(c, "powmod")
    L = pack_powmod(x, digits, c, mode, table)
    nwin = L.nwin  # mpcflow: declassified — the window count, a width
    if mode == "comb" and nwin > COMB_MAX_WINDOWS:
        raise ValueError(f"powmod kernel: {nwin} comb windows exceed {COMB_MAX_WINDOWS}")
    for t in (L.x, L.digits, L.table):
        if t is not None and (t.device != dev or dev.type != "cuda"):
            where = t.device  # mpcflow: declassified — a device name
            raise ValueError(f"powmod kernel: tensor on {where}, consts on {dev}")
    out = torch.empty((L.rows, n), dtype=torch.int32, device=dev)
    if L.rows == 0:
        return out.reshape(L.shape + (n,))
    rc = launch_powmod(L, c, out)  # mpcflow: declassified — a CUDA status code
    if rc != 0:
        raise RuntimeError(f"powmod kernel launch failed: CUDA error {rc}")
    key = (mode, n)
    with _count_lock:
        powmod_launches_by_mode_width[key] = powmod_launches_by_mode_width.get(key, 0) + 1
    return out.reshape(L.shape + (n,))


def launch_powmod(L: PowmodLaunch, c: MulmodConsts, out: torch.Tensor) -> int:
    """One launch of the powmod kernel's C entry on packed operands into
    ``out`` (rows, n), on ``out``'s device and its current stream; counts
    nothing, checks nothing, returns the CUDA error code."""
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rpow = c.exit_words if L.mode == "comb" else None
    lib = build()
    with torch.cuda.device(out.device):
        return lib.mpcium_powmod(
            ptr(L.x), L.digits.data_ptr(), ptr(L.table), ptr(rpow), out.data_ptr(),
            c.mont_words.data_ptr(), c.mprime, L.rows, c.n, c.k, L.nwin,
            L.stride, POWMOD_MODES.index(L.mode),
            torch.cuda.current_stream(out.device).cuda_stream,
        )


def _table16(x: torch.Tensor, c: MulmodConsts):
    from .modmul import _one_like

    rows = [_one_like(x, c.n), x]
    for _ in range(14):
        rows.append(_mulmod_plain(rows[-1], x, c))
    return rows


def powmod_plain(x, digits: torch.Tensor, c: MulmodConsts, mode: str,
                 table: Optional[CombTable] = None) -> torch.Tensor:
    """The plain PyTorch version: the 4-bit window loops (8-bit comb) over
    :func:`mulmod_plain`'s arithmetic, one eager product per step."""
    global plain_calls
    from .modmul import _one_like

    if mode not in POWMOD_MODES:
        raise ValueError(f"powmod: mode {mode!r} not in {POWMOD_MODES}")
    with _count_lock:
        plain_calls += 1
    n = c.n
    if mode == "comb":
        acc = None
        for i in range(digits.shape[-1]):
            sel = table.limbs[i][digits[..., i].long()]
            acc = sel if acc is None else _mulmod_plain(acc, sel, c)
        return acc
    if mode == "shared":
        ds = digits.tolist()  # mpcflow: host-ok — plain twin: runs only on CPU tensors; the card's powmod takes its digits on device
        while ds and not ds[-1]:
            ds.pop()
        if not ds:
            return _one_like(x, n)
        rows = _table16(x, c)
        acc = rows[ds[-1]]
        for d in reversed(ds[:-1]):
            for _ in range(4):
                acc = _mulmod_plain(acc, acc, c)
            if d:
                acc = _mulmod_plain(acc, rows[d], c)
        return acc
    shape = torch.broadcast_shapes(x.shape[:-1], digits.shape[:-1])
    x = x.expand(shape + (n,))
    digits = digits.long().expand(shape + (-1,))
    tbl = torch.stack(_table16(x, c), dim=-2)  # (..., 16, n)
    acc = None
    for i in range(digits.shape[-1] - 1, -1, -1):
        idx = digits[..., i, None, None].expand(shape + (1, n))
        sel = tbl.gather(-2, idx).squeeze(-2)
        if acc is None:
            acc = sel
            continue
        for _ in range(4):
            acc = _mulmod_plain(acc, acc, c)
        acc = _mulmod_plain(acc, sel, c)
    return acc
