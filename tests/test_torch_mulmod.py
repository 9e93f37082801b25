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


def _words_value(row) -> int:
    return sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row))


@pytest.mark.parametrize("bits,w", [(1024, 1), (2048, 2), (2040, 2), (4096, 4)])
def test_kernel_consts_are_radix_2_32_montgomery_words(bits, w):
    """The kernel's per-modulus constants: m over s = 32·w words (w words
    a lane), m' = -m^-1 mod 2^32, and the two entry constants that make
    every bit of a kw-word row count."""
    m, _, _ = _operands(bits, seed=11)
    ctx = mm.MXUBarrett(m, device="cpu")
    c = ctx._kc
    s = 32 * w
    assert (c.k, c.w, c.s) == (-(-bits // 32), w, s)
    assert c.kw == -(-(7 * ctx.prof.n_limbs) // 32) >= c.k
    assert tuple(c.mont_words.shape) == (3, s) and c.mont_words.dtype == torch.int32
    m_w, c_mul, c_pow = (_words_value(r) for r in c.mont_words.tolist())
    assert m_w == m
    assert (m * c.mprime + 1) % (1 << 32) == 0 and 0 <= c.mprime < 1 << 32
    assert c_mul == (1 << (64 * c.kw)) % m
    assert c_pow == (1 << (32 * (c.kw + s))) % m
    # the two entries: mont_kw(a, c_mul) = a·2^(32kw), mont_kw(x, c_pow) = x·R
    r_kw = pow(1 << (32 * c.kw), -1, m)
    assert c_mul * r_kw % m == (1 << (32 * c.kw)) % m
    assert c_pow * r_kw % m == (1 << (32 * s)) % m


def test_even_modulus_raises_on_the_kernel_path_and_runs_plain():
    m = (1 << 255) + 2 * random.Random(4).getrandbits(200)
    ctx = mm.MXUBarrett(m, device="cpu")
    c = ctx._kc
    assert c.mprime == 0 and not c.mont_words.any()
    a = _limbs([m - 1, 3, 0, 12345], ctx.prof)
    b = _limbs([m - 1, m - 2, 7, 99], ctx.prof)
    K.reset_counters()
    with pytest.raises(ValueError, match="mulmod kernel: the modulus is even"):
        K.mulmod_cuda(a, b, c)
    d = torch.tensor([[1, 2]] * 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="powmod kernel: the modulus is even"):
        K.powmod_cuda(a, d, c, "row")
    assert K.launches == 0 and K.powmod_launches_by_mode_width == {}
    assert bn.batch_from_limbs(K.mulmod(a, b, c), ctx.prof) == [
        x * y % m for x, y in ((m - 1, m - 1), (3, m - 2), (0, 7), (12345, 99))
    ]
    got = K.powmod(a, d, c, "row")
    assert bn.batch_from_limbs(got, ctx.prof) == [pow(x, 0x21, m) for x in (m - 1, 3, 0, 12345)]


def test_comb_exit_table_bounds_the_kernel_comb():
    """The consts hold R^j mod m up to the widest comb the kernel takes;
    one window more raises on the kernel path before anything launches."""
    m = (1 << 255) + 2 * random.Random(5).getrandbits(200) + 1
    c = mm.MXUBarrett(m, device="cpu")._kc
    R = 1 << (32 * c.s)
    ex = [_words_value(r) for r in c.exit_words[[0, 1, -1]].tolist()]
    assert ex == [1, R % m, pow(R, K.COMB_MAX_WINDOWS, m)]
    for nw, msg in ((K.COMB_MAX_WINDOWS + 1, "comb windows exceed"),
                    (K.COMB_MAX_WINDOWS, "tensor on cpu")):
        table = K.CombTable(torch.zeros((nw, K.COMB_ROWS, c.n), dtype=torch.int32),
                            torch.zeros((nw, K.COMB_ROWS, c.k), dtype=torch.int32))
        d = torch.zeros((2, nw), dtype=torch.int32)
        with pytest.raises(ValueError, match=msg):
            K.powmod_cuda(None, d, c, "comb", table)


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


def test_counters_are_exact_under_concurrent_threads():
    """The nodes of an in-process cluster sign on concurrent threads:
    every plain call made from eight threads at once is counted."""
    import threading

    m, av, bv = _operands(256, seed=11)
    ctx = mm.MXUBarrett(m, device="cpu")
    a, b = _limbs(av, ctx.prof), _limbs(bv, ctx.prof)
    want = [x * y % m for x, y in zip(av, bv)]
    calls, errors = 150, []
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(calls):
            if bn.batch_from_limbs(K.mulmod(a, b, ctx._kc), ctx.prof) != want:
                errors.append("wrong product")

    K.reset_counters()
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert (K.plain_calls, K.launches) == (8 * calls, 0)
