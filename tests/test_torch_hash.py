"""The port's batched SHA-256 (ops/sha256.py) against hashlib and the JAX
package's device SHA-256 on ragged lengths. Exact equality."""
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpcium_tpu.ops import hash_suite as jhs
from mpcium_tpu_torch.engine.gg18_batch import dev_hash
from mpcium_tpu_torch.ops.sha256 import sha256

torch.set_num_threads(1)


def _msgs(length: int, B: int = 3) -> np.ndarray:
    return np.random.default_rng(length).integers(0, 256, (B, length), dtype=np.uint8)


@pytest.mark.parametrize("length", [0, 1, 3, 55, 56, 63, 64, 100, 200, 1000])
def test_sha256_matches_hashlib(length):
    data = _msgs(length)
    got = sha256(torch.as_tensor(data)).numpy()
    for row, d in zip(data, got):
        assert bytes(d) == hashlib.sha256(row.tobytes()).digest()


@pytest.mark.parametrize("length", [0, 55, 64, 200])
def test_sha256_matches_jax(length):
    data = _msgs(length, B=2)
    ref = np.asarray(jhs.sha256(jnp.asarray(data)))
    assert np.array_equal(sha256(torch.as_tensor(data)).numpy(), ref)


def test_engine_hash_binds_the_wire_tag():
    rows = torch.as_tensor(_msgs(33, B=2))
    idx = torch.full((2, 1), 1, dtype=torch.uint8)
    got = dev_hash(b"gamma", idx, rows).numpy()
    for r, d in zip(rows.numpy(), got):
        msg = b"mpcium-tpu/gg18-batch/gamma" + b"\x01" + r.tobytes()
        assert bytes(d) == hashlib.sha256(msg).digest()
