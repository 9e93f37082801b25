"""The port's mulmod (ops/mulmod.py) against python ints and the JAX
package: the plain PyTorch version on the CPU, exact equality.

The JAX side runs as its own tests run on the CPU: ``modmul._k_mulmod``
(the band path) and the Pallas kernel in ``interpret=True``. The CUDA
kernel itself is checked on the card by ``test_kernel_matches_plain_on_gpu``
(skipped without a GPU) and by chip_smoke.py.
"""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpcium_tpu.ops import modmul as jmm
from mpcium_tpu.ops import pallas_mulmod as pmm
from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.ops import modmul as mm
from mpcium_tpu_torch.ops import mulmod as K

torch.set_num_threads(1)


def _operands(bits: int, seed: int, B: int = 8):
    """A modulus of ``bits`` bits and B operand pairs with the edges 0, 1
    and m-1 (the most conditional-subtraction pressure), plus unreduced
    operands the JAX kernel still accepts (a·b < R^occ·m): R^occ - 1 and,
    where it lies below R^occ, 2^(32k), the first bit past m's k words."""
    rnd = random.Random(seed)
    m = rnd.getrandbits(bits) | (1 << (bits - 1)) | 1
    av = [0, 1, m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
    bv = [rnd.randrange(m), m - 1, m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
    top = 1 << (7 * -(-bits // 7))  # R^occ
    edges = [top - 1] + [1 << (32 * -(-bits // 32))] * (1 << (32 * -(-bits // 32)) < top)
    for e in edges:
        av += [e, m - 1]
        bv += [m - 1, e]
    return m, av, bv


def _limbs(vals, prof):
    return torch.as_tensor(bn.batch_to_limbs(vals, prof))


# 1000 and 2040 bits leave the top limb(s) of the block-padded profile
# empty (occ < n)
@pytest.mark.parametrize("bits", [256, 1000, 1024, 2040, 2048, 4096])
def test_mulmod_plain_matches_python_and_jax(bits):
    m, av, bv = _operands(bits, seed=bits)
    ctx = mm.MXUBarrett(m, device="cpu")
    jctx = jmm.MXUBarrett(m)
    a, b = _limbs(av, ctx.prof), _limbs(bv, ctx.prof)
    out = K.mulmod_plain(a, b, ctx._kc)
    assert bn.batch_from_limbs(out, ctx.prof) == [x * y % m for x, y in zip(av, bv)]
    ref = jmm._k_mulmod(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), jctx._T_mu, jctx._T_m,
        jctx._comp, jctx.occ, jctx.prof.n_limbs,
    )
    assert np.array_equal(np.asarray(ref), bn.limbs_to_numpy(out))


def test_mulmod_broadcasts_a_constant_row():
    m, av, bv = _operands(1024, seed=7)
    ctx = mm.MXUBarrett(m, device="cpu")
    c = bn.batch_to_limbs([bv[3]], ctx.prof)[0]
    out = K.mulmod(_limbs(av, ctx.prof), torch.as_tensor(c), ctx._kc)
    assert out.shape == (len(av), ctx.prof.n_limbs)
    assert bn.batch_from_limbs(out, ctx.prof) == [x * bv[3] % m for x in av]


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    m, av, bv = _operands(512, seed=3)
    ctx = mm.MXUBarrett(m, device="cpu")
    a, b = _limbs(av, ctx.prof), _limbs(bv, ctx.prof)
    K.reset_counters()
    ctx.mulmod(a, b)
    assert (K.launches, K.plain_calls) == (0, 1)
    with pytest.raises(ValueError, match="mulmod kernel"):
        K.mulmod_cuda(a, b, ctx._kc)
    assert K.launches == 0


def test_kernel_consts_are_radix_2_32_barrett_words():
    m, _, _ = _operands(2048, seed=11)
    ctx = mm.MXUBarrett(m, device="cpu")
    c = ctx._kc
    words = lambda t: sum(  # noqa: E731
        (int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(t.tolist())
    )
    assert (c.k, c.kw) == (64, 70) and words(c.m_words) == m
    assert words(c.mu_words) == (1 << (64 * c.kw)) // m
    # the top k+1 words of mu are the narrow Barrett constant
    assert words(c.mu_words) >> (64 * (c.kw - c.k)) == (1 << (64 * c.k)) // m


def _pallas_case(bits: int):
    m, av, bv = _operands(bits, seed=bits + 1)
    ctx = mm.MXUBarrett(m, device="cpu")
    jctx = jmm.MXUBarrett(m)
    a, b = _limbs(av, ctx.prof), _limbs(bv, ctx.prof)
    out = K.mulmod_plain(a, b, ctx._kc)
    ref = pmm.mulmod(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), jctx._T_mu, jctx._T_m,
        jctx._comp, jctx.occ, jctx.prof.n_limbs, interpret=True,
    )
    assert np.array_equal(np.asarray(ref), bn.limbs_to_numpy(out))


def test_mulmod_plain_matches_pallas_interpret_256():
    _pallas_case(256)


@pytest.mark.slow
@pytest.mark.parametrize("bits", [2048, 4096])
def test_mulmod_plain_matches_pallas_interpret_wide(bits):
    _pallas_case(bits)


def test_kernel_matches_plain_on_gpu():
    """Runs only where there is a CUDA card (chip_smoke.py covers the
    full widths at B=1024)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    for bits in (2048, 4096):
        m, av, bv = _operands(bits, seed=bits + 2, B=64)
        ctx = mm.MXUBarrett(m, device="cuda")
        a = _limbs(av, ctx.prof).cuda()
        b = _limbs(bv, ctx.prof).cuda()
        got = K.mulmod_cuda(a, b, ctx._kc)
        torch.cuda.synchronize()
        assert torch.equal(got, K.mulmod_plain(a, b, ctx._kc))
        assert bn.batch_from_limbs(got, ctx.prof) == [x * y % m for x, y in zip(av, bv)]
        # beyond the JAX kernel's domain the kernel stays exact
        full = (1 << (7 * ctx.prof.n_limbs)) - 1
        half = 1 << (7 * ctx.prof.n_limbs - 1)
        wide = _limbs([full, full, half], ctx.prof).cuda()
        got = K.mulmod_cuda(wide, wide.flip(0), ctx._kc)
        assert bn.batch_from_limbs(got, ctx.prof) == [
            full * half % m, full * full % m, full * half % m,
        ]
