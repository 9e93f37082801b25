"""Batched a·b mod m: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``mpcium_tpu/ops/pallas_mulmod.py:_mulmod_kernel``
(the only ``pallas_call`` in the JAX package). Every ``MXUBarrett``
mulmod and every multiply step of its powmod loops comes here, the
counterpart of ``mpcium_tpu/ops/modmul._mm``: a CUDA tensor launches the
kernel in ``csrc/mulmod.cu`` (or raises), a CPU tensor takes
:func:`mulmod_plain`. There is no switch and no fallback.

Both versions take normalized (..., n) limbs. The plain version is
exact where the JAX kernel is, for a·b < R^occ·m (operands above m
included); the kernel is exact for every normalized n-limb pair, so the
two agree bit for bit wherever the JAX kernel is defined.

What bounds the kernel on an H100 is integer multiply throughput, not
bytes (~7.5 MB in and out per 4096-bit call at B=1024 against ~85 M
32-bit word products). The kernel repacks rows into 32-bit words and
reduces in radix 2^32 (see the source note in ``csrc/mulmod.cu``);
warpgroup MMA, TMA and in-kernel exponent loops are later work.

The library is compiled with ``nvcc`` into ``build/mpcium_tpu_torch/``
at the first CUDA call and bound with ctypes (plain C interface, no
PyTorch headers).

Counters: ``launches`` counts kernel launches, ``launches_by_width`` the
same per limb width n, ``plain_calls`` calls of :func:`mulmod_plain`.
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
from typing import Dict, Optional

import numpy as np
import torch

LIMB_BITS = 7
MAX_LIMBS = 608  # 4256 bits: the 4096-bit Paillier N² width
_KMAX, _LMAX = 136, 160  # csrc/mulmod.cu

launches = 0
launches_by_width: Dict[int, int] = {}
plain_calls = 0

SRC = Path(__file__).resolve().parent / "csrc" / "mulmod.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mpcium_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
build_log = ""


def reset_counters() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0
    launches_by_width.clear()


@dataclass(frozen=True)
class MulmodConsts:
    """Per-modulus operands, built once by ``MXUBarrett``: the Toeplitz
    constants of the plain (7-bit Barrett) version and, for the kernel,
    the 32-bit word arrays of m (k words) and of mu = floor(2^(64·kw) / m),
    where kw = ceil(7n/32) words hold a whole row."""

    modulus: int
    occ: int
    n: int
    T_mu: torch.Tensor
    T_m: torch.Tensor
    comps: torch.Tensor
    k: int
    kw: int
    m_words: torch.Tensor
    mu_words: torch.Tensor


def _words(v: int, count: int, device) -> torch.Tensor:
    arr = np.array(
        [(v >> (32 * i)) & 0xFFFFFFFF for i in range(count)], dtype=np.uint32
    )
    return torch.as_tensor(arr.view(np.int32), device=device)


def make_consts(modulus: int, occ: int, n: int, T_mu, T_m, comps, device) -> MulmodConsts:
    k = -(-modulus.bit_length() // 32)
    kw = -(-(LIMB_BITS * n) // 32)
    mu = (1 << (64 * kw)) // modulus
    if mu >> (32 * (2 * kw - k + 1)):
        raise ValueError("mulmod kernel: the modulus must exceed 2^(32(k-1))")
    return MulmodConsts(
        modulus, occ, n, T_mu, T_m, comps, k, kw,
        _words(modulus, k, device), _words(mu, 2 * kw - k + 1, device),
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
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


def mulmod_cuda(a: torch.Tensor, b: torch.Tensor, c: MulmodConsts) -> torch.Tensor:
    global launches
    n = c.n
    dev = c.m_words.device
    for t in (a, b):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"mulmod kernel: tensor on {t.device}, consts on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"mulmod kernel takes int32 limbs, got {t.dtype}")
        if t.shape[-1] != n:
            raise ValueError(f"mulmod kernel: width {t.shape[-1]} != {n}")
    if n > MAX_LIMBS or c.kw > _KMAX or 2 * c.kw - c.k + 1 > _LMAX:
        raise ValueError(f"mulmod kernel: width {n} limbs exceeds {MAX_LIMBS}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a2 = a.expand(shape).reshape(-1, n).contiguous()
    b2 = b.expand(shape).reshape(-1, n).contiguous()
    rows = a2.shape[0]
    out = torch.empty_like(a2)
    if rows == 0:
        return out.reshape(shape)
    rc = build().mpcium_mulmod(
        a2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        c.m_words.data_ptr(), c.mu_words.data_ptr(), rows, n, c.k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mulmod kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_by_width[n] = launches_by_width.get(n, 0) + 1
    return out.reshape(shape)


def mulmod_plain(a: torch.Tensor, b: torch.Tensor, c: MulmodConsts) -> torch.Tensor:
    """The plain PyTorch version: float64 band product, lookahead carries
    and the Barrett reduction of ``modmul._reduce_impl`` (7-bit radix)."""
    global plain_calls
    from .modmul import _reduce_impl, mul_pair

    plain_calls += 1
    return _reduce_impl(mul_pair(a, b), c.T_mu, c.T_m, c.comps, c.occ, c.n)
