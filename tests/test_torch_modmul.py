"""The port's MXUBarrett (ops/modmul.py) method by method against the JAX
package's on the same modulus and inputs, and against python ints.
Exact equality everywhere (integer arithmetic).

Tier-1 compares every method with python ints at both moduli, and with
JAX at a 256-bit modulus (the ring methods and the fixed-base comb);
the slow tier compares every
method with JAX at 1024 bits and at the 2048-bit fixture modulus (each
JAX exponentiation compiles its own scan for tens of seconds on a CPU).
"""
import math
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpcium_tpu.ops import modmul as jmm
from mpcium_tpu_torch.cluster import load_test_preparams
from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.ops import modmul as mm

torch.set_num_threads(1)
B = 4


def _modulus(kind: str) -> int:
    if kind == "rand1024":
        return random.Random(5).getrandbits(1024) | (1 << 1023) | 1
    return load_test_preparams(2048)["node1"].NTilde  # 2048-bit fixture


@pytest.fixture(scope="module", params=["rand1024", "fixture2048"])
def case(request):
    m = _modulus(request.param)
    rnd = random.Random(m & 0xFFFF)
    ctx = mm.MXUBarrett(m, device="cpu")
    av = [0, 1, m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
    bv = [m - 1, rnd.randrange(m), m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
    e_bits = np.random.default_rng(m & 0xFF).integers(0, 2, (B, 300)).astype(np.int32)
    return request.param, m, ctx, av, bv, e_bits


def _t(vals, ctx):
    return torch.as_tensor(bn.batch_to_limbs(vals, ctx.prof))


def _ints(x, ctx):
    return bn.batch_from_limbs(x, ctx.prof)


def _exps(e_bits):
    return [int("".join(str(b) for b in row[::-1]), 2) for row in e_bits]


def _j(x):
    return jnp.asarray(bn.limbs_to_numpy(x))


def test_ring_ops_match_python(case):
    _, m, ctx, av, bv, _ = case
    a, b = _t(av, ctx), _t(bv, ctx)
    assert _ints(ctx.mulmod(a, b), ctx) == [x * y % m for x, y in zip(av, bv)]
    assert _ints(ctx.addmod(a, b), ctx) == [(x + y) % m for x, y in zip(av, bv)]
    assert _ints(ctx.submod(a, b), ctx) == [(x - y) % m for x, y in zip(av, bv)]
    assert _ints(ctx.negmod(a), ctx) == [-x % m for x in av]
    assert _ints(ctx.mulmod_const(a, 0xC0FFEE), ctx) == [x * 0xC0FFEE % m for x in av]
    wide = [x * y for x, y in zip(av, bv)]
    assert _ints(ctx.reduce(mm.mul_pair(a, b)), ctx) == [w % m for w in wide]
    assert _ints(ctx.prod_over_batch(a[1:])[None], ctx) == [math.prod(av[1:]) % m]


def test_exponentiations_match_python(case):
    _, m, ctx, av, _, e_bits = case
    a = _t(av, ctx)
    es = _exps(e_bits)
    eb = torch.as_tensor(e_bits)
    assert _ints(ctx.powmod(a, eb), ctx) == [pow(x, e, m) for x, e in zip(av, es)]
    assert _ints(ctx.powmod_const_exp(a, 65537), ctx) == [pow(x, 65537, m) for x in av]
    assert _ints(ctx.powmod_fixed_base(7, eb), ctx) == [pow(7, e, m) for e in es]


@pytest.mark.slow
def test_ring_methods_match_jax():
    m = _modulus("rand1024")
    rnd = random.Random(4)
    av = [0, 1, m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
    bv = [m - 1, rnd.randrange(m), m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
    _compare_ring(mm.MXUBarrett(m, device="cpu"), jmm.MXUBarrett(m), av, bv)


def _compare_ring(ctx, jctx, av, bv):
    a, b = _t(av, ctx), _t(bv, ctx)
    ja, jb = _j(a), _j(b)
    pairs = [
        (ctx.reduce(mm.mul_pair(a, b)), jctx.reduce(jmm.mul_pair(ja, jb))),
        (ctx.mulmod(a, b), jctx.mulmod(ja, jb)),
        (ctx.mulmod_const(a, 0xC0FFEE), jctx.mulmod_const(ja, 0xC0FFEE)),
        (ctx.addmod(a, b), jctx.addmod(ja, jb)),
        (ctx.submod(a, b), jctx.submod(ja, jb)),
        (ctx.negmod(a), jctx.negmod(ja)),
        (ctx.prod_over_batch(a[1:]), jctx.prod_over_batch(ja[1:])),
    ]
    for i, (got, ref) in enumerate(pairs):
        assert np.array_equal(bn.limbs_to_numpy(got), np.asarray(ref)), i


def _compare_exps(ctx, jctx, av, e_bits):
    a = _t(av, ctx)
    ja = _j(a)
    eb = torch.as_tensor(e_bits)
    jeb = jnp.asarray(e_bits)
    pairs = [
        (ctx.powmod(a, eb), jctx.powmod(ja, jeb)),
        (ctx.powmod_const_exp(a, 65537), jctx.powmod_const_exp(ja, 65537)),
        (ctx.powmod_fixed_base(7, eb), jctx.powmod_fixed_base(7, jeb)),
    ]
    for i, (got, ref) in enumerate(pairs):
        assert np.array_equal(bn.limbs_to_numpy(got), np.asarray(ref)), i


def test_methods_match_jax_256():
    """The ring methods and the fixed-base comb against JAX at the
    smallest width (the windowed powmods compile scans for tens of
    seconds and are compared in the slow tier)."""
    m = random.Random(6).getrandbits(256) | (1 << 255) | 1
    rnd = random.Random(10)
    av = [0, 1, m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
    bv = [m - 1, rnd.randrange(m), m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
    e_bits = np.random.default_rng(10).integers(0, 2, (B, 40)).astype(np.int32)
    ctx, jctx = mm.MXUBarrett(m, device="cpu"), jmm.MXUBarrett(m)
    _compare_ring(ctx, jctx, av, bv)
    got = ctx.powmod_fixed_base(7, torch.as_tensor(e_bits))
    ref = jctx.powmod_fixed_base(7, jnp.asarray(e_bits))
    assert np.array_equal(bn.limbs_to_numpy(got), np.asarray(ref))
    assert _ints(got, ctx) == [pow(7, e, m) for e in _exps(e_bits)]


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["rand1024", "fixture2048"])
def test_methods_match_jax_slow(kind):
    """Every method, the exponentiations included, at both moduli (each
    JAX exponentiation compiles its own scan for tens of seconds)."""
    m = _modulus(kind)
    rnd = random.Random(9)
    av = [0, 1, m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
    bv = [rnd.randrange(m) for _ in range(B)]
    e_bits = np.random.default_rng(9).integers(0, 2, (B, 300)).astype(np.int32)
    ctx, jctx = mm.MXUBarrett(m, device="cpu"), jmm.MXUBarrett(m)
    _compare_ring(ctx, jctx, av, bv)
    _compare_exps(ctx, jctx, av, e_bits)


@pytest.mark.parametrize("with_jax", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_carry_and_products_match_jax(with_jax):
    rng = np.random.default_rng(2)
    red = rng.integers(0, 1 << 24, (3, 200)).astype(np.int32)
    red[:, -2:] = 0  # room for the carries out of the top
    x = rng.integers(0, 128, (3, 150)).astype(np.int32)
    y = rng.integers(0, 128, (3, 97)).astype(np.int32)
    T = mm._const_matrices(0xDEADBEEF12345, 150)
    got = [
        mm.carry(torch.as_tensor(red)),
        mm.mul_pair(torch.as_tensor(x), torch.as_tensor(y)),
        mm.mul_const(torch.as_tensor(x), T),
    ]
    val = lambda row, w: sum(int(v) << (7 * i) for i, v in enumerate(row))  # noqa: E731
    # carries out of the top limb drop (mod R^200), as in the JAX package
    assert bn.batch_from_limbs(got[0], mm._P7) == [val(r, 7) % (1 << 1400) for r in red]
    assert bn.batch_from_limbs(got[1], mm._P7) == [
        val(a, 7) * val(b, 7) for a, b in zip(x, y)
    ]
    assert [val(r, 7) for r in bn.limbs_to_numpy(got[2])] == [
        val(a, 7) * 0xDEADBEEF12345 for a in x
    ]
    if with_jax:
        refs = [
            jmm.carry(jnp.asarray(red)),
            jmm.mul_pair(jnp.asarray(x), jnp.asarray(y)),
            jmm.mul_const(jnp.asarray(x), jmm._const_matrices(0xDEADBEEF12345, 150)),
        ]
        for g, r in zip(got, refs):
            assert np.array_equal(bn.limbs_to_numpy(g), np.asarray(r))


def test_exactness_guards_raise_where_jax_does():
    wide = np.zeros((1, 33 * 32), np.int32)  # 33 blocks: past the exact domain
    with pytest.raises(ValueError):
        jmm._mul_pair_bf16(jnp.asarray(wide), jnp.asarray(wide))
    with pytest.raises(ValueError, match="exact domain"):
        mm.mul_pair(torch.as_tensor(wide), torch.as_tensor(wide))
    # 32 blocks is still inside it
    ok = torch.full((1, 32 * 32), 127, dtype=torch.int32)
    v = bn.batch_from_limbs(ok, mm._P7)[0]
    assert bn.batch_from_limbs(mm.mul_pair(ok, ok), mm._P7)[0] == v * v
    x = torch.zeros((1, 1041), dtype=torch.int32)
    with pytest.raises(ValueError, match="mul_const"):
        mm.mul_const(x, mm._const_matrices(3, 1041))
    with pytest.raises(ValueError, match="mul_const"):
        mm.mul_const(x[:, :10], mm._const_matrices(3, 12))


def test_context_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mm.MXUBarrett(_modulus("rand1024"))
