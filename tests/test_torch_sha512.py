"""The port's batched SHA-512 (ops/hash_suite.py) against hashlib and the
JAX package's device SHA-512. Exact equality.

The lengths straddle the block boundary: 111 bytes is the longest
message that fits one 128-byte block (128 - 1 - 16), 112 the first that
needs two; 96 is the RFC 8032 challenge R ‖ A ‖ M of a 32-byte message.
"""
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpcium_tpu.ops import hash_suite as jhs
from mpcium_tpu_torch.ops import hash_suite as hs

torch.set_num_threads(1)
LENGTHS = [0, 1, 96, 111, 112, 127, 128, 129, 239, 240]


def _msgs(shape, length: int) -> np.ndarray:
    return np.random.default_rng(1000 + length).integers(
        0, 256, tuple(shape) + (length,), dtype=np.uint8
    )


@pytest.mark.parametrize("length", LENGTHS)
def test_sha512_matches_hashlib(length):
    data = _msgs((2, 3), length)  # (q, B, L)
    got = hs.sha512(torch.as_tensor(data)).numpy()
    assert got.shape == (2, 3, 64)
    for row, d in zip(data.reshape(6, length), got.reshape(6, 64)):
        assert bytes(d) == hashlib.sha512(row.tobytes()).digest()


@pytest.mark.parametrize("length", LENGTHS)
def test_sha512_matches_jax(length):
    data = _msgs((2, 2), length)
    ref = np.asarray(jhs.sha512(jnp.asarray(data)))
    assert np.array_equal(hs.sha512(torch.as_tensor(data)).numpy(), ref)


def test_sha512_word_edges_match_hashlib():
    """All-ones and all-zero blocks drive every word to 0xFF…F (negative
    as int64) and every add to wrap."""
    data = np.stack([np.full(240, 0xFF, np.uint8), np.zeros(240, np.uint8),
                     np.tile(np.array([0x80, 0x7F], np.uint8), 120)])
    got = hs.sha512(torch.as_tensor(data)).numpy()
    for row, d in zip(data, got):
        assert bytes(d) == hashlib.sha512(row.tobytes()).digest()


def test_sha512_constants_and_single_digest():
    assert hs._K512[0] == 0x428A2F98D728AE22
    assert hs._K512[-1] == 0x6C44198C4A475817
    assert hs._K512[2] == 0xB5C0FBCFEC4D3B2F - (1 << 64)  # ≥ 2^63: negative
    assert [k & ((1 << 64) - 1) for k in hs._K512] == list(jhs._K512_INT)
    assert [h & ((1 << 64) - 1) for h in hs._H512] == list(jhs._H512_INT)
    abc = bytes(hs.sha512(hs.as_bytes(b"abc", "cpu")).numpy())
    assert abc == hashlib.sha512(b"abc").digest() == jhs.sha512_bytes(b"abc")


def test_md_pad_matches_jax_for_both_widths():
    for length in (0, 55, 56, 111, 112, 200):
        data = _msgs((2,), length)
        for block, len_bytes in ((64, 8), (128, 16)):
            got = hs._md_pad(torch.as_tensor(data), length, block, len_bytes).numpy()
            ref = np.asarray(jhs._md_pad(jnp.asarray(data), length, block, len_bytes))
            assert np.array_equal(got, ref)
            assert got.shape[-1] % block == 0
