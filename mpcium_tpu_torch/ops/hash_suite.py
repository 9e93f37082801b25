"""Batched SHA-256 on the device (FIPS 180-4), fixed message length.

The SHA-256 half of ``mpcium_tpu/ops/hash_suite.py``. torch has no
uint32 shifts on the CPU, so 32-bit words are held in int64 tensors and
masked with ``& 0xFFFFFFFF`` after every add; right rotations take one
shift of the word doubled into the high half (``x | x << 32``). The
64 rounds are a Python loop over (B,) lanes — the state is eight
tensors, the schedule plus round constants one (B, 64) tensor.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _primes(n: int):
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out):
            out.append(c)
        c += 1
    return out


def _icbrt(n: int) -> int:
    x = 1 << -(-n.bit_length() // 3)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            return x
        x = y


_P64 = _primes(64)
# frac(cbrt(p)) · 2^32 and frac(sqrt(p)) · 2^32
_K256 = [_icbrt(p << 96) & _M32 for p in _P64]
_H256 = [math.isqrt(p << 64) & _M32 for p in _P64[:8]]
assert _K256[0] == 0x428A2F98 and _H256[0] == 0x6A09E667


def _rotr_sum(x: torch.Tensor, a: int, b: int, c: int) -> torch.Tensor:
    """rotr(x, a) ^ rotr(x, b) ^ rotr(x, c) for 32-bit x in int64."""
    d = x | (x << 32)
    return ((d >> a) ^ (d >> b) ^ (d >> c)) & _M32


def _sigma(x: torch.Tensor, a: int, b: int, s: int) -> torch.Tensor:
    """rotr(x, a) ^ rotr(x, b) ^ (x >> s) (message schedule)."""
    d = x | (x << 32)
    return ((d >> a) ^ (d >> b)) & _M32 ^ (x >> s)


def sha256_compress(state: List[torch.Tensor], block: torch.Tensor) -> List[torch.Tensor]:
    """state: eight (...,) int64 words; block (..., 16) int64 words → new
    state."""
    w = list(block.unbind(-1))
    for t in range(16, 64):
        s0 = _sigma(w[t - 15], 7, 18, 3)
        s1 = _sigma(w[t - 2], 17, 19, 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = h + _rotr_sum(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + (w[t] + _K256[t])
        t2 = _rotr_sum(a, 2, 13, 22) + ((a & b) | (c & (a | b)))
        h, g, f = g, f, e
        e = (d + t1) & _M32
        d, c, b = c, b, a
        a = (t1 + t2) & _M32
    return [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def bytes_to_words32(b: torch.Tensor) -> torch.Tensor:
    """(..., 4k) uint8 big-endian → (..., k) int64 words."""
    k = b.shape[-1] // 4
    w = b.reshape(b.shape[:-1] + (k, 4)).to(torch.int64)
    return (w << torch.tensor([24, 16, 8, 0], device=b.device)).sum(-1)


def words32_to_bytes(w: torch.Tensor) -> torch.Tensor:
    sh = torch.tensor([24, 16, 8, 0], device=w.device)
    out = ((w.unsqueeze(-1) >> sh) & 0xFF).to(torch.uint8)
    return out.reshape(w.shape[:-1] + (w.shape[-1] * 4,))


def _md_pad(data: torch.Tensor, msg_len: int) -> torch.Tensor:
    """0x80, zeros, big-endian 64-bit bit length to a 64-byte multiple."""
    pad_total = (-(msg_len + 9)) % 64 + 9
    tail = np.zeros(pad_total, np.uint8)
    tail[0] = 0x80
    tail[-8:] = np.frombuffer((msg_len * 8).to_bytes(8, "big"), np.uint8)
    t = torch.as_tensor(tail, device=data.device).expand(data.shape[:-1] + (pad_total,))
    return torch.cat([data, t], dim=-1)


def sha256_core(data: torch.Tensor, msg_len: int) -> torch.Tensor:
    """(..., msg_len) uint8 → (..., 32) uint8 digests."""
    words = bytes_to_words32(_md_pad(data, msg_len))
    state = [
        torch.full(data.shape[:-1], h, dtype=torch.int64, device=data.device)
        for h in _H256
    ]
    for i in range(words.shape[-1] // 16):
        state = sha256_compress(state, words[..., 16 * i: 16 * (i + 1)])
    return words32_to_bytes(torch.stack(state, dim=-1))


def sha256(data: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256 over the last axis: (..., L) uint8 → (..., 32)."""
    return sha256_core(data, data.shape[-1])
