"""The OT half of the port's hash suite (mpcium_tpu_torch/ops/hash_suite.py)
against the JAX package's functions on the same numpy inputs: PRG
expansion, pad hashing across the SHA-256 block boundary, the packed bit
transpose, bit packing and the little-endian counters. Exact equality."""
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpcium_tpu.ops import hash_suite as jhs
from mpcium_tpu_torch.ops import hash_suite as hs

torch.set_num_threads(1)


def _bytes(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("blk_off", [0, 37])
def test_prg_expand_matches_jax_and_hashlib(blk_off):
    seeds = _bytes((128, 32), 1)
    prefix = b"mpcium-ot-prg|node0->node1|v3|12"
    got = hs.prg_expand(prefix, seeds, 3, blk_off).numpy()
    want = np.asarray(jhs.prg_expand_device(prefix, seeds, 3, blk_off))
    assert got.shape == (128, 96)
    assert np.array_equal(got, want)
    for j in (0, 1, 127):
        for b in range(3):
            msg = (prefix + seeds[j].tobytes() + j.to_bytes(2, "little")
                   + (blk_off + b).to_bytes(4, "little"))
            assert got[j, 32 * b:32 * (b + 1)].tobytes() == hashlib.sha256(msg).digest()


def test_prg_chunks_equal_the_full_expansion():
    """A chunk at block offset c·Bc is the matching slice of the full
    expansion; stacked seed matrices hash as independent ones."""
    seeds = torch.as_tensor(_bytes((2, 16, 32), 2))
    prefix = hs.as_bytes(b"mpcium-ot-prg|t|v3|0")
    full = hs.prg_expand_core(seeds, prefix, 4, 0)
    parts = [hs.prg_expand_core(seeds, prefix, 2, off) for off in (0, 2)]
    assert torch.equal(torch.cat(parts, dim=-1), full)
    assert torch.equal(full[1], hs.prg_expand_core(seeds[1], prefix, 4, 0))


@pytest.mark.parametrize("msg_len", [54, 55, 56, 57])
def test_pad_hash_matches_jax_across_the_block_boundary(msg_len):
    """Pad messages are prefix ‖ 16 row bytes ‖ le32 index: 55 bytes fit
    one SHA-256 block, 56 take two (the tag's counter reaches 100)."""
    prefix = b"p" * (msg_len - 20)
    rows = _bytes((64, 16), msg_len)
    got = hs.pad_hash(prefix, rows, m_off=1000).numpy()
    want = np.asarray(jhs.pad_hash_device(
        jnp.asarray(np.frombuffer(prefix, np.uint8)), jnp.asarray(rows), 1000
    ))
    assert np.array_equal(got, want)
    assert got[3].tobytes() == hashlib.sha256(
        prefix + rows[3].tobytes() + (1003).to_bytes(4, "little")
    ).digest()


def test_pad_hash_broadcasts_domains_and_row_sets():
    prefixes = hs.as_bytes(np.frombuffer(b"mpcium-ot-pad|t|s0mpcium-ot-pad|t|s1", np.uint8)
                           .reshape(2, -1))
    rows = torch.as_tensor(_bytes((3, 8, 16), 3))
    idx = hs.le32_bytes(torch.arange(8))
    got = hs.pad_hash_core(prefixes[:, None, :], rows[None], idx)
    assert got.shape == (2, 3, 8, 32)
    assert torch.equal(got[1, 2], hs.pad_hash_core(prefixes[1], rows[2], idx))


@pytest.mark.parametrize("shape", [(128, 128), (128, 24), (64, 40)])
def test_ot_transpose_matches_jax_and_numpy(shape):
    packed = _bytes(shape, shape[1])
    got = hs.ot_transpose(packed).numpy()
    assert np.array_equal(got, np.asarray(jhs.ot_transpose_device(jnp.asarray(packed))))
    bits = np.unpackbits(packed, axis=-1, bitorder="little")
    assert np.array_equal(got, np.packbits(bits.T, axis=-1, bitorder="little"))
    assert np.array_equal(hs.ot_transpose(got).numpy(), packed)


@pytest.mark.parametrize("shape", [(16,), (3, 5, 32)])
def test_pack_unpack_round_trip_little_bitorder(shape):
    packed = _bytes(shape, 4)
    bits = hs.unpack_bits_core(torch.as_tensor(packed))
    assert np.array_equal(bits.numpy(), np.unpackbits(packed, axis=-1, bitorder="little"))
    assert np.array_equal(bits.numpy(), np.asarray(jhs.unpack_bits_core(jnp.asarray(packed))))
    assert np.array_equal(hs.pack_bits_core(bits).numpy(), packed)
    assert np.array_equal(
        hs.pack_bits_core(bits).numpy(), np.asarray(jhs.pack_bits_core(jnp.asarray(bits.numpy())))
    )


def test_little_endian_counters_match_jax():
    x = np.array([0, 1, 255, 256, 65535, 65536, 2**32 - 1], np.int64)
    assert np.array_equal(
        hs.le32_bytes(torch.as_tensor(x)).numpy(),
        np.asarray(jhs.le32_bytes(jnp.asarray(x.astype(np.uint32)))),
    )
    assert np.array_equal(
        hs.le16_bytes(torch.as_tensor(x[:5])).numpy(),
        np.asarray(jhs.le16_bytes(jnp.asarray(x[:5].astype(np.uint32)))),
    )
