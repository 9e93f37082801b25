"""Native (C++) host components, built by g++ and loaded with ctypes.

The port of ``mpcium_tpu/native/``, from its own copy of the source
(``batch_hash.cpp``): row-batched SHA-256 and SHA-512 (one call per batch
instead of one hashlib call per row), and the OT-MtA host extension's hot
loops — :func:`ot_transpose` (packed bit-matrix transpose),
:func:`prg_expand` (fused seed → SHA-256 block expansion) and
:func:`xor_rows` (in-place masking). Every loop threads across rows;
``MPCIUM_NATIVE_THREADS`` pins the count, read at every call (1 = one
thread; the bytes are the same at any count, since rows write disjoint
ranges). ctypes drops the GIL for the length of each call.

The library is compiled at the first call, never at import, with
``g++ -O3 -shared -fPIC -std=c++17 … -lpthread`` into
``build/mpcium_tpu_torch/libbatchhash_<digest>.so``, keyed by the digest
of the source and the flags, through a per-pid temporary file and
``os.replace``, so concurrent processes can build at once. Where there is
no compiler or the build fails, the call raises ``RuntimeError`` with the
compiler's name and its log: nothing falls back to hashlib or numpy. The
hashlib and numpy versions of each entry live in :mod:`.plain`, for the
tests.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "batch_hash.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mpcium_tpu_torch"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lpthread"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
build_log = ""

_SHA_ARGS = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
             ctypes.c_size_t, ctypes.c_void_p]
_SIGNATURES = {
    "batch_sha256": _SHA_ARGS,
    "batch_sha512": _SHA_ARGS,
    "ot_transpose": [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p],
    "prg_expand": [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                   ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p],
    "xor_rows": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t],
    "xor_bcast_row": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t],
}


def _cxx() -> str:
    path = shutil.which(CXX)
    if path is None:
        raise RuntimeError(
            f"{CXX} not found: mpcium_tpu_torch.native builds {SRC.name} with it"
        )
    return path


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        flags = CXX_FLAGS + LIBS
        digest = hashlib.sha256(SRC.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"libbatchhash_{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS],
                capture_output=True, text=True,
            )
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"{CXX} failed for {SRC.name}:\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        lib.native_threads.argtypes = []
        lib.native_threads.restype = ctypes.c_uint
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here (a probe for reports and
    tests; the entries themselves raise when it does not)."""
    try:
        build()
    except RuntimeError:
        return False
    return True


def threads() -> int:
    """The thread count a threaded entry would use now."""
    return int(build().native_threads())


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _batch_sha(fn_name: str, width: int, prefix: bytes, rows: np.ndarray) -> np.ndarray:
    lib = build()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    B, W = rows.shape
    out = np.empty((B, width), dtype=np.uint8)
    getattr(lib, fn_name)(prefix, len(prefix), _ptr(rows), W, B, _ptr(out))
    return out


def batch_sha256(prefix: bytes, rows: np.ndarray) -> np.ndarray:
    """SHA-256(prefix ‖ row) for every row of a (B, W) uint8 array → (B, 32)."""
    return _batch_sha("batch_sha256", 32, prefix, rows)


def batch_sha512(prefix: bytes, rows: np.ndarray) -> np.ndarray:
    """SHA-512(prefix ‖ row) per row → (B, 64)."""
    return _batch_sha("batch_sha512", 64, prefix, rows)


def ot_transpose(packed: np.ndarray) -> np.ndarray:
    """Packed bit-matrix transpose: ``packed`` (κ, m/8) uint8, numpy
    little-bitorder packing along the last axis → (m, κ/8), row j the κ
    bits of column j re-packed. κ must be a multiple of 8 (the output
    is κ/8 wide, so other bits would be dropped)."""
    lib = build()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    kappa = packed.shape[0]  # mpcflow: declassified — the matrix height κ is a public parameter
    if kappa % 8:
        raise ValueError(f"ot_transpose: kappa={kappa} not a multiple of 8")
    m = packed.shape[1] * 8
    out = np.empty((m, kappa // 8), dtype=np.uint8)
    lib.ot_transpose(_ptr(packed), kappa, m, _ptr(out))
    return out


def prg_expand(prefix: bytes, seeds: np.ndarray, n_blocks: int, blk_off: int = 0) -> np.ndarray:
    """Fused PRG expansion: each 32-byte seed row j expands to
    ``n_blocks`` SHA-256 blocks sha256(prefix ‖ seed_j ‖ le16(j) ‖
    le32(blk_off + b)) → (n_seeds, n_blocks·32). ``blk_off`` starts the
    block counter mid-stream, so chunks concatenate to the full
    expansion."""
    lib = build()
    seeds = np.ascontiguousarray(seeds, dtype=np.uint8)
    n_seeds = seeds.shape[0]
    if seeds.ndim != 2 or seeds.shape[1] != 32 or n_seeds >= (1 << 16):
        raise ValueError("prg_expand: seeds must be (n < 2^16, 32) bytes")
    out = np.empty((n_seeds, n_blocks * 32), dtype=np.uint8)
    lib.prg_expand(prefix, len(prefix), _ptr(seeds), n_seeds, n_blocks, blk_off, _ptr(out))
    return out


def xor_rows(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """In-place ``dst ^= src``, returning ``dst``. ``src`` is either the
    size of ``dst`` or one row broadcast across dst's leading axes. A
    ``dst`` the library cannot write through (not uint8, not
    C-contiguous, read-only) or a size that is neither takes numpy's
    in-place xor, which gives the same bytes."""
    lib = build()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if dst.dtype != np.uint8 or not dst.flags.c_contiguous or not dst.flags.writeable:
        np.bitwise_xor(dst, src, out=dst)
    elif src.size == dst.size:
        lib.xor_rows(_ptr(dst), _ptr(src), dst.size)
    elif src.size and dst.size % src.size == 0:
        lib.xor_bcast_row(_ptr(dst), _ptr(src), dst.size // src.size, src.size)
    else:
        np.bitwise_xor(dst, src, out=dst)
    return dst
