"""Batched SHA-256 and SHA-512 on the device (FIPS 180-4) and the OT
hot-path hashes.

The port of ``mpcium_tpu/ops/hash_suite.py``: SHA-256, SHA-512 and the
OT half:
the IKNP PRG expansion, the packed bit transpose and the per-OT pad
hash (:func:`prg_expand_core`, :func:`ot_transpose_core`,
:func:`pad_hash_core`), byte for byte the JAX functions. The JAX
package's jitted entries (``prg_expand_device``, ``ot_transpose_device``,
``pad_hash_device``) are plain functions here that take a device. Bytes
are uint8 tensors; counters and indices are int64 (no uint32 in torch).

torch has no
uint32 shifts on the CPU, so 32-bit words are held in int64 tensors and
masked with ``& 0xFFFFFFFF`` after every add; right rotations take one
shift of the word doubled into the high half (``x | x << 32``). The
64 rounds are a Python loop over (B,) lanes — the state is eight
tensors, the schedule plus round constants one (B, 64) tensor.

SHA-512 holds one 64-bit word per int64 lane (the JAX package splits it
into (hi, lo) uint32 halves only because the TPU has no 64-bit lanes).
Three things keep int64 exact for unsigned words: adds wrap mod 2^64
in two's complement, which is the unsigned sum's bit pattern; ``>>`` is
arithmetic, so every logical shift masks off the sign-extended high
bits; and constants ≥ 2^63 enter as their negative two's-complement
values.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..device import resolve

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


_P80 = _primes(80)
# frac(cbrt(p)) · 2^32 and frac(sqrt(p)) · 2^32
_K256 = [_icbrt(p << 96) & _M32 for p in _P80[:64]]
_H256 = [math.isqrt(p << 64) & _M32 for p in _P80[:8]]
assert _K256[0] == 0x428A2F98 and _H256[0] == 0x6A09E667


def _signed64(v: int) -> int:
    """Unsigned 64-bit value → the int64 with the same bits."""
    return v - (1 << 64) if v >> 63 else v


_M64 = (1 << 64) - 1
# frac(cbrt(p)) · 2^64 and frac(sqrt(p)) · 2^64, as int64 bit patterns
_K512_INT = [_icbrt(p << 192) & _M64 for p in _P80]
_H512_INT = [math.isqrt(p << 128) & _M64 for p in _P80[:8]]
assert _K512_INT[0] == 0x428A2F98D728AE22 and _H512_INT[0] == 0x6A09E667F3BCC908
_K512 = [_signed64(k) for k in _K512_INT]
_H512 = [_signed64(h) for h in _H512_INT]


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


def _md_pad(data: torch.Tensor, msg_len: int, block: int, len_bytes: int) -> torch.Tensor:
    """Merkle–Damgård strengthening: 0x80, zeros, and the big-endian bit
    length in the trailing ``len_bytes`` (its bytes above the low eight
    stay zero), to a ``block``-byte multiple — shared by both widths."""
    pad_total = (-(msg_len + 1 + len_bytes)) % block + 1 + len_bytes
    tail = np.zeros(pad_total, np.uint8)
    tail[0] = 0x80
    tail[-8:] = np.frombuffer((msg_len * 8).to_bytes(8, "big"), np.uint8)
    t = torch.as_tensor(tail, device=data.device).expand(data.shape[:-1] + (pad_total,))
    return torch.cat([data, t], dim=-1)


def sha256_core(data: torch.Tensor, msg_len: int) -> torch.Tensor:
    """(..., msg_len) uint8 → (..., 32) uint8 digests."""
    words = bytes_to_words32(_md_pad(data, msg_len, 64, 8))
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


# ---------------------------------------------------------------------------
# SHA-512: one 64-bit word per int64 lane
# ---------------------------------------------------------------------------


def _shr64(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of a 64-bit word held in int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr64(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr64(x, n) | (x << (64 - n))


def sha512_compress(state: List[torch.Tensor], block: torch.Tensor) -> List[torch.Tensor]:
    """state: eight (...,) int64 words; block (..., 16) int64 words → new
    state (every add wraps mod 2^64)."""
    w = list(block.unbind(-1))
    for t in range(16, 80):
        x, y = w[t - 15], w[t - 2]
        s0 = _rotr64(x, 1) ^ _rotr64(x, 8) ^ _shr64(x, 7)
        s1 = _rotr64(y, 19) ^ _rotr64(y, 61) ^ _shr64(y, 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        S1 = _rotr64(e, 14) ^ _rotr64(e, 18) ^ _rotr64(e, 41)
        t1 = h + S1 + (g ^ (e & (f ^ g))) + (w[t] + _K512[t])
        S0 = _rotr64(a, 28) ^ _rotr64(a, 34) ^ _rotr64(a, 39)
        t2 = S0 + ((a & b) | (c & (a | b)))
        h, g, f = g, f, e
        e = d + t1
        d, c, b = c, b, a
        a = t1 + t2
    return [x + y for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def bytes_to_words64(b: torch.Tensor) -> torch.Tensor:
    """(..., 8k) uint8 big-endian → (..., k) int64 words (two's complement)."""
    w32 = bytes_to_words32(b)
    return (w32[..., 0::2] << 32) | w32[..., 1::2]


def words64_to_bytes(w: torch.Tensor) -> torch.Tensor:
    sh = torch.arange(56, -1, -8, dtype=torch.int64, device=w.device)
    out = ((w.unsqueeze(-1) >> sh) & 0xFF).to(torch.uint8)
    return out.reshape(w.shape[:-1] + (w.shape[-1] * 8,))


def sha512_core(data: torch.Tensor, msg_len: int) -> torch.Tensor:
    """(..., msg_len) uint8 → (..., 64) uint8 digests. 128-byte blocks;
    the 16-byte length field's high quadword is zero."""
    words = bytes_to_words64(_md_pad(data, msg_len, 128, 16))
    state = [
        torch.full(data.shape[:-1], h, dtype=torch.int64, device=data.device)
        for h in _H512
    ]
    for i in range(words.shape[-1] // 16):
        state = sha512_compress(state, words[..., 16 * i: 16 * (i + 1)])
    return words64_to_bytes(torch.stack(state, dim=-1))


def sha512(data: torch.Tensor) -> torch.Tensor:
    """Batched SHA-512 over the last axis: (..., L) uint8 → (..., 64)."""
    return sha512_core(data, data.shape[-1])


def sha512_bytes(data: bytes, device=None) -> bytes:
    """One message's SHA-512 through the batched :func:`sha512` on
    ``device`` (None: the GPU, raising when there is none) → 64 digest
    bytes. The per-session EdDSA party routes its RFC 8032 challenge
    here under ``MPCIUM_EDDSA_DEVICE_HASH_SESSION=1``."""
    return bytes(sha512(as_bytes(data, resolve(device))).cpu().numpy())  # mpcflow: host-ok — single-digest egress for the host protocol caller


# ---------------------------------------------------------------------------
# OT hot path: PRG expansion, packed bit transpose, pad hash
# ---------------------------------------------------------------------------


def le16_bytes(x: torch.Tensor) -> torch.Tensor:
    """int64 (...,) → (..., 2) little-endian uint8."""
    return torch.stack([x & 0xFF, (x >> 8) & 0xFF], dim=-1).to(torch.uint8)


def le32_bytes(x: torch.Tensor) -> torch.Tensor:
    """int64 (...,) → (..., 4) little-endian uint8."""
    return torch.stack(
        [(x >> (8 * i)) & 0xFF for i in range(4)], dim=-1
    ).to(torch.uint8)


def as_bytes(data, device=None) -> torch.Tensor:
    """bytes / numpy uint8 / tensor → uint8 tensor on ``device`` (None:
    a tensor stays where it is, host data goes to the CPU)."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.uint8) if device is None else data.to(device, torch.uint8)
    if isinstance(data, (bytes, bytearray)):
        data = np.frombuffer(bytes(data), np.uint8)
    arr = np.asarray(data, dtype=np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.as_tensor(arr, device=device)


def prg_expand_core(
    seeds: torch.Tensor, prefix: torch.Tensor, nblk: int, blk_off: int
) -> torch.Tensor:
    """(..., n, 32) uint8 seeds → (..., n, nblk·32) keystream, block
    (j, b) = sha256(prefix ‖ seed_j ‖ le16(j) ‖ le32(blk_off + b)), j
    counting along the seed axis. ``blk_off`` starts the block counter
    mid-stream, so a chunk of the expansion equals the matching slice of
    the full one. Leading axes stack independent seed matrices into one
    hash call."""
    lead, n = seeds.shape[:-2], seeds.shape[-2]
    P, dev = prefix.shape[0], seeds.device
    shape = lead + (n, nblk)
    j_le = le16_bytes(torch.arange(n, dtype=torch.int64, device=dev))
    blk_le = le32_bytes(
        int(blk_off) + torch.arange(nblk, dtype=torch.int64, device=dev)
    )
    msg = torch.cat(
        [
            prefix.expand(shape + (P,)),
            seeds[..., None, :].expand(shape + (32,)),
            j_le[:, None, :].expand(shape + (2,)),
            blk_le.expand(shape + (4,)),
        ],
        dim=-1,
    )
    return sha256_core(msg, P + 38).reshape(lead + (n, nblk * 32))


def prg_expand(prefix: bytes, seeds, nblk: int, blk_off: int = 0,
               device=None) -> torch.Tensor:
    """Entry matching ``native.prg_expand``: (n, 32) seeds → (n, nblk·32)
    keystream on ``device`` (default: the seeds' device)."""
    seeds = as_bytes(seeds, device)
    return prg_expand_core(seeds, as_bytes(prefix, seeds.device), nblk, blk_off)


def pack_bits_core(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8k) 0/1 → (..., k) packed little-bitorder uint8 (the twin
    of ``np.packbits(..., bitorder="little")``)."""
    k = bits.shape[-1] // 8
    grouped = bits.reshape(bits.shape[:-1] + (k, 8)).to(torch.int64)
    w = torch.arange(8, dtype=torch.int64, device=bits.device)
    return (grouped << w).sum(-1).to(torch.uint8)


def unpack_bits_core(packed: torch.Tensor) -> torch.Tensor:
    """(..., k) uint8 → (..., 8k) 0/1 uint8, little bitorder."""
    sh = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> sh) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))


def ot_transpose_core(packed: torch.Tensor) -> torch.Tensor:
    """(R, C) packed little-bitorder bytes → the packed transpose
    (8C, R/8); R must be a multiple of 8."""
    return pack_bits_core(unpack_bits_core(packed).T)


def ot_transpose(packed, device=None) -> torch.Tensor:
    """Entry for wire bytes: (R, C) packed → (8C, R/8) on ``device``."""
    return ot_transpose_core(as_bytes(packed, device))


def pad_hash_core(
    prefix: torch.Tensor, rows: torch.Tensor, idx_le: torch.Tensor
) -> torch.Tensor:
    """Per-OT correlation pads H(prefix ‖ row_j ‖ le32(index_j)):
    prefix (..., P), rows (..., M, r), idx_le (M, 4) → (..., M, 32), the
    leading axes broadcast (several pad domains or row sets per call)."""
    M, P = rows.shape[-2], prefix.shape[-1]
    lead = torch.broadcast_shapes(prefix.shape[:-1], rows.shape[:-2])
    msg = torch.cat(
        [
            prefix[..., None, :].expand(lead + (M, P)),
            rows.expand(lead + rows.shape[-2:]),
            idx_le.expand(lead + (M, 4)),
        ],
        dim=-1,
    )
    return sha256_core(msg, msg.shape[-1])


def pad_hash(prefix: bytes, rows, m_off: int = 0, device=None) -> torch.Tensor:
    """Pads for OT indices [m_off, m_off + M) of (M, r) rows on
    ``device``."""
    rows = as_bytes(rows, device)
    idx = le32_bytes(
        int(m_off) + torch.arange(rows.shape[0], dtype=torch.int64, device=rows.device)
    )
    return pad_hash_core(as_bytes(prefix, rows.device), rows, idx)
