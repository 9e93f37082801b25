"""The hashlib and numpy versions of :mod:`mpcium_tpu_torch.native`'s
entries, byte for byte the same results, for the tests to hold the
library to. Nothing on the program's path calls them: where the library
does not build, its entries raise."""
from __future__ import annotations

import hashlib

import numpy as np


def _batch(fn, width: int, prefix: bytes, rows: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    out = np.empty((rows.shape[0], width), np.uint8)
    for i, r in enumerate(rows):
        out[i] = np.frombuffer(fn(prefix + r.tobytes()).digest(), np.uint8)
    return out


def batch_sha256(prefix: bytes, rows: np.ndarray) -> np.ndarray:
    return _batch(hashlib.sha256, 32, prefix, rows)


def batch_sha512(prefix: bytes, rows: np.ndarray) -> np.ndarray:
    return _batch(hashlib.sha512, 64, prefix, rows)


def ot_transpose(packed: np.ndarray) -> np.ndarray:
    """Unpack the (κ, m/8) little-bitorder matrix, transpose, re-pack →
    (m, κ/8)."""
    m = packed.shape[1] * 8
    bits = np.unpackbits(packed, axis=-1, count=m, bitorder="little")
    return np.packbits(bits.T, axis=-1, bitorder="little")


def prg_expand(prefix: bytes, seeds: np.ndarray, n_blocks: int, blk_off: int = 0) -> np.ndarray:
    """The (n_seeds·n_blocks, 38) message matrix seed ‖ le16(j) ‖
    le32(blk_off + b), hashed row by row under ``prefix``."""
    n_seeds = seeds.shape[0]
    rows = np.empty((n_seeds * n_blocks, 38), np.uint8)
    rows[:, :32] = np.repeat(seeds, n_blocks, axis=0)
    j_ids = np.repeat(np.arange(n_seeds, dtype="<u2"), n_blocks)
    rows[:, 32:34] = j_ids.view(np.uint8).reshape(-1, 2)
    blk = np.tile(np.arange(blk_off, blk_off + n_blocks, dtype="<u4"), n_seeds)
    rows[:, 34:38] = blk.view(np.uint8).reshape(-1, 4)
    return batch_sha256(prefix, rows).reshape(n_seeds, n_blocks * 32)


def xor_rows(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    np.bitwise_xor(dst, np.asarray(src, np.uint8), out=dst)
    return dst
