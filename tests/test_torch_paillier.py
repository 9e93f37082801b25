"""The port's batched Paillier (ops/paillier_mxu.py) on the 1024-bit
fixture: encryption against the closed form and the JAX package's
PaillierMXU.encrypt with the same y and u bits, CRT decryption, and the
homomorphic add / scalar multiply. Exact equality. Tier-1 also holds
encryption and the homomorphic add against JAX on a small key (Mersenne
primes 2^127 - 1 and 2^89 - 1); the JAX CRT decryption compiles its
exponent scans for tens of seconds and is compared in the slow tier."""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpcium_tpu.cluster import load_test_preparams as jax_preparams
from mpcium_tpu.core.paillier import PaillierPrivateKey as JaxPaillierKey
from mpcium_tpu.ops import paillier_mxu as jpm
from mpcium_tpu_torch.cluster import load_test_preparams
from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.core.paillier import PaillierPrivateKey
from mpcium_tpu_torch.ops.paillier_mxu import RAND_BITS, PaillierMXUPrivate

torch.set_num_threads(1)
B = 3


@pytest.fixture(scope="module")
def key():
    sk = load_test_preparams(1024)["node0"].paillier
    pmx = PaillierMXUPrivate(sk, y=123456789, device="cpu")
    rnd = random.Random(21)
    ms = [0, sk.N - 1] + [rnd.randrange(sk.N) for _ in range(B - 2)]
    u = np.random.default_rng(21).integers(0, 2, (B, RAND_BITS)).astype(np.int32)
    return sk, pmx, ms, u


def _exp(bits_row) -> int:
    return sum(int(b) << i for i, b in enumerate(bits_row))


def test_encrypt_matches_closed_form_and_decrypts(key):
    sk, pmx, ms, u = key
    N, N2 = sk.N, sk.N * sk.N
    c, r = pmx.encrypt(torch.as_tensor(bn.batch_to_limbs(ms, pmx.prof_n)),
                       torch.as_tensor(u))
    for i, m in enumerate(ms):
        ui = _exp(u[i])
        assert bn.batch_from_limbs(r[i:i + 1], pmx.prof_n)[0] == pow(pmx.y, ui, N)
        want = (1 + m * N) * pow(pmx.h, ui, N2) % N2
        assert bn.batch_from_limbs(c[i:i + 1], pmx.prof_n2)[0] == want
        assert sk.decrypt(want) == m
    assert bn.batch_from_limbs(pmx.decrypt(c), pmx.prof_n) == ms


def test_homomorphic_add_and_scalar_mul(key):
    sk, pmx, ms, u = key
    c, _ = pmx.encrypt(torch.as_tensor(bn.batch_to_limbs(ms, pmx.prof_n)),
                       torch.as_tensor(u))
    k = np.random.default_rng(4).integers(0, 2, (B, 64)).astype(np.int32)
    ks = [_exp(row) for row in k]
    summed = pmx.decrypt(pmx.add(c, c.flip(0)))
    assert bn.batch_from_limbs(summed, pmx.prof_n) == [
        (a + b) % sk.N for a, b in zip(ms, ms[::-1])
    ]
    scaled = pmx.decrypt(pmx.scalar_mul(c, torch.as_tensor(k)))
    assert bn.batch_from_limbs(scaled, pmx.prof_n) == [
        m * kk % sk.N for m, kk in zip(ms, ks)
    ]


@pytest.mark.slow
def test_encrypt_matches_jax(key):
    """Same y, same u bits: the JAX package's ciphertext and randomizer
    (its fixed-base scans compile for tens of seconds on a CPU)."""
    sk, pmx, ms, u = key
    jsk = jax_preparams(1024)["node0"].paillier
    jpmx = jpm.PaillierMXUPrivate(jsk, y=pmx.y)
    m_l = bn.batch_to_limbs(ms, pmx.prof_n)
    c, r = pmx.encrypt(torch.as_tensor(m_l), torch.as_tensor(u))
    jc, jr = jpmx.encrypt(jnp.asarray(m_l), jnp.asarray(u))
    assert np.array_equal(bn.limbs_to_numpy(c), np.asarray(jc))
    assert np.array_equal(bn.limbs_to_numpy(r), np.asarray(jr))
    assert np.array_equal(bn.limbs_to_numpy(pmx.decrypt(c)),
                          np.asarray(jpmx.decrypt(jc)))


def test_encrypt_and_add_match_jax_small_key():
    p, q = (1 << 127) - 1, (1 << 89) - 1
    pmx = PaillierMXUPrivate(PaillierPrivateKey(p, q), y=987654321, device="cpu")
    jpmx = jpm.PaillierMXUPrivate(JaxPaillierKey(p, q), y=pmx.y)
    N = p * q
    rnd = random.Random(22)
    ms = [0, 1, N - 1] + [rnd.randrange(N) for _ in range(B - 2)]
    u = np.random.default_rng(22).integers(0, 2, (len(ms), RAND_BITS)).astype(np.int32)
    m_l = bn.batch_to_limbs(ms, pmx.prof_n)
    c, r = pmx.encrypt(torch.as_tensor(m_l), torch.as_tensor(u))
    jc, jr = jpmx.encrypt(jnp.asarray(m_l), jnp.asarray(u))
    assert np.array_equal(bn.limbs_to_numpy(c), np.asarray(jc))
    assert np.array_equal(bn.limbs_to_numpy(r), np.asarray(jr))
    assert np.array_equal(bn.limbs_to_numpy(pmx.add(c, c.flip(0))),
                          np.asarray(jpmx.add(jc, jc[::-1])))
    assert bn.batch_from_limbs(pmx.decrypt(c), pmx.prof_n) == ms
