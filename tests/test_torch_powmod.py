"""The port's whole-exponentiation entry (ops/mulmod.powmod) against
python ints and the JAX package, exact equality.

On the CPU the entry runs its plain version, the window loops over the
plain mulmod; tier-1 holds it against python ``pow`` and, at 256 bits,
against the JAX package's ``_k_powmod`` (per-row exponent),
``_k_powmod_digits`` (batch-shared exponent) and ``_k_powmod_fb``
(fixed-base comb). It also checks what the kernel receives: the digit
arrays, the shared exponent's zero stride, the comb table's word form
and the step counts of the kernel's schedule.

This module imports no JAX at its top, so its GPU case runs where JAX
is not installed:

    python -m pytest --noconftest tests/test_torch_powmod.py -q -k gpu

(``--noconftest``: ``tests/conftest.py`` imports JAX). Without a CUDA
card that case skips; chip_smoke.py covers the kernel at B=1024.
"""
import random

import numpy as np
import pytest
import torch

from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.ops import modmul as mm
from mpcium_tpu_torch.ops import mulmod as K

torch.set_num_threads(1)
B = 8
E_BITS = 40


def _modulus(bits: int) -> int:
    return random.Random(bits).getrandbits(bits) | (1 << (bits - 1)) | 1


def _case(bits: int, seed: int, rows: int = B, e_bits: int = E_BITS):
    """Bases with the edges 0, 1 and m-1, and exponent bits with the edges
    e = 0, e = 1 and all ones (LSB-first), the rest random."""
    m = _modulus(bits)
    rnd = random.Random(seed)
    xs = [0, 1, m - 1] + [rnd.randrange(m) for _ in range(rows - 3)]
    eb = np.random.default_rng(seed).integers(0, 2, (rows, e_bits)).astype(np.int32)
    eb[3], eb[4], eb[5] = 0, 0, 1
    eb[4, 0] = 1
    return m, xs, eb


def _exps(eb):
    return [sum(int(b) << i for i, b in enumerate(row)) for row in eb]


def _limbs(vals, prof):
    return torch.as_tensor(bn.batch_to_limbs(vals, prof))


def _ints(x, ctx):
    return bn.batch_from_limbs(x, ctx.prof)


def _words_value(row) -> int:
    return sum((int(w) & 0xFFFFFFFF) << (32 * j) for j, w in enumerate(row))


# 1000 bits leaves the top limbs of the block-padded profile empty
@pytest.mark.parametrize("bits", [256, 1000])
@pytest.mark.parametrize("mode", K.POWMOD_MODES)
def test_plain_matches_python(mode, bits):
    m, xs, eb = _case(bits, seed=bits + 1)
    ctx = mm.MXUBarrett(m, device="cpu")
    x = _limbs(xs, ctx.prof)
    es = _exps(eb)
    K.reset_counters()
    if mode == "row":
        got, want = ctx.powmod(x, torch.as_tensor(eb)), [pow(v, e, m) for v, e in zip(xs, es)]
    elif mode == "shared":
        e = es[-1]
        got, want = ctx.powmod_const_exp(x, e), [pow(v, e, m) for v in xs]
    else:
        got, want = ctx.powmod_fixed_base(5, torch.as_tensor(eb)), [pow(5, e, m) for e in es]
    assert _ints(got, ctx) == want
    # one plain call per exponentiation, no launch
    assert (K.plain_calls, K.launches, K.powmod_launches_by_mode_width) == (1, 0, {})


def test_shared_exponent_edges_match_python():
    m, xs, _ = _case(256, seed=2)
    ctx = mm.MXUBarrett(m, device="cpu")
    x = _limbs(xs, ctx.prof)
    for e in (0, 1, 15, 16, (1 << 64) - 1, m - 2):
        assert _ints(ctx.powmod_const_exp(x, e), ctx) == [pow(v, e, m) for v in xs]
    # leading zero digits are allowed
    digits = torch.tensor([3, 0, 0, 0], dtype=torch.int32)
    assert _ints(K.powmod(x, digits, ctx._kc, "shared"), ctx) == [pow(v, 3, m) for v in xs]
    assert _ints(K.powmod(x, digits * 0, ctx._kc, "shared"), ctx) == [1] * len(xs)


@pytest.mark.parametrize("mode", K.POWMOD_MODES)
def test_plain_matches_jax_256(mode):
    """The plain version against the JAX package's exponent loops at the
    smallest width (the JAX side compiles one scan per mode)."""
    import jax.numpy as jnp

    from mpcium_tpu.ops import modmul as jmm

    m, xs, eb = _case(256, seed=3)
    ctx, jctx = mm.MXUBarrett(m, device="cpu"), jmm.MXUBarrett(m)
    x = _limbs(xs, ctx.prof)
    jx = jnp.asarray(x.numpy())
    consts = (jctx._T_mu, jctx._T_m, jctx._comp, jctx.occ, jctx.prof.n_limbs)
    if mode == "row":
        got = K.powmod_plain(x, mm._window_digits(torch.as_tensor(eb), 4), ctx._kc, "row")
        ref = jmm._k_powmod(jx, jnp.asarray(eb), *consts)
        want = [pow(v, e, m) for v, e in zip(xs, _exps(eb))]
    elif mode == "shared":
        e = 0xC0FFEE1
        nw = -(-e.bit_length() // 4)
        lsd = [(e >> (4 * i)) & 15 for i in range(nw)]
        got = K.powmod_plain(x, torch.tensor(lsd, dtype=torch.int32), ctx._kc, "shared")
        ref = jmm._k_powmod_digits(jx, jnp.asarray(lsd[::-1], jnp.int32), *consts)
        want = [pow(v, e, m) for v in xs]
    else:
        got = ctx.powmod_fixed_base(11, torch.as_tensor(eb))
        tbl = ctx._fb_tables[(11, E_BITS // mm.COMB_W, mm.COMB_W)]
        # the port's comb table holds the JAX package's limbs
        jref = jctx.powmod_fixed_base(11, jnp.asarray(eb))
        jtbl = jctx._fb_tables[(11, E_BITS // jmm.COMB_W, jmm.COMB_W)]
        assert np.array_equal(tbl.limbs.numpy(), np.asarray(jtbl))
        ref = jmm._k_powmod_fb(jnp.asarray(tbl.limbs.numpy()), jnp.asarray(eb), *consts)
        assert np.array_equal(np.asarray(ref), np.asarray(jref))
        want = [pow(11, e, m) for e in _exps(eb)]
    assert np.array_equal(bn.limbs_to_numpy(got), np.asarray(ref))
    assert _ints(got, ctx) == want


def test_packing_row_and_shared_digits():
    m, xs, eb = _case(1000, seed=4, e_bits=43)  # 43 bits: a padded top window
    ctx = mm.MXUBarrett(m, device="cpu")
    x = _limbs(xs, ctx.prof)
    es = _exps(eb)
    L = K.pack_powmod(x, mm._window_digits(torch.as_tensor(eb), 4), ctx._kc, "row")
    assert (L.rows, L.nwin, L.stride, L.shape) == (B, 11, 11, (B,))
    assert L.digits.dtype == torch.int32 and L.digits.is_contiguous()
    assert L.digits.tolist() == [[(e >> (4 * i)) & 15 for i in range(11)] for e in es]
    assert L.x.dtype == torch.int32 and torch.equal(L.x, x) and L.table is None
    # schedule: 15 table steps, then 4 squarings + 1 multiply per non-zero
    # digit below the top non-zero window; e = 0 takes none
    want = []
    for d in L.digits.tolist():
        nz = [i for i, v in enumerate(d) if v]
        want.append(0 if not nz else 15 + 4 * nz[-1] + len(nz) - 1)
    assert K.powmod_steps(L).tolist() == want
    assert want[3] == 0 and want[4] == 15 and want[5] == 15 + 4 * 10 + 10
    # one base broadcast against per-row exponents
    L1 = K.pack_powmod(x[2], L.digits, ctx._kc, "row")
    assert L1.rows == B and torch.equal(L1.x, x[2].expand(B, -1))
    # a batch-shared exponent: one digit array, row stride 0
    e = m - 2
    nw = -(-e.bit_length() // 4)
    digits = torch.tensor([(e >> (4 * i)) & 15 for i in range(nw)], dtype=torch.int32)
    L2 = K.pack_powmod(x.reshape(2, B // 2, -1), digits, ctx._kc, "shared")
    assert (L2.rows, L2.nwin, L2.stride, L2.shape) == (B, nw, 0, (2, B // 2))
    assert sum(d << (4 * i) for i, d in enumerate(L2.digits.tolist())) == e
    assert K.powmod_steps(L2).tolist() == [15 + 4 * (nw - 1) + sum(
        1 for d in digits[:-1].tolist() if d)] * B


def test_packing_comb_digits_and_word_table():
    m, _, eb = _case(1000, seed=5, e_bits=36)  # 36 bits: 5 windows, one padded
    ctx = mm.MXUBarrett(m, device="cpu")
    es = _exps(eb)
    got = ctx.powmod_fixed_base(3, torch.as_tensor(eb))
    assert _ints(got, ctx) == [pow(3, e, m) for e in es]
    tbl = ctx._fb_tables[(3, 5, mm.COMB_W)]
    k = ctx._kc.k
    assert tuple(tbl.words.shape) == (5, K.COMB_ROWS, k) == (5, 256, 32)
    assert tbl.words.dtype == torch.int32
    for i, d in [(0, 0), (0, 1), (1, 255), (4, 17), (3, 200)]:
        v = pow(3, d << (8 * i), m)
        assert _words_value(tbl.words[i, d].tolist()) == v
        assert bn.from_limbs(tbl.limbs[i, d].numpy(), ctx.prof) == v
    L = K.pack_powmod(None, mm._window_digits(torch.as_tensor(eb), 8), ctx._kc, "comb", tbl)
    assert (L.rows, L.nwin, L.stride, L.x) == (B, 5, 5, None)
    assert L.table is tbl.words
    assert L.digits.tolist() == [[(e >> (8 * i)) & 255 for i in range(5)] for e in es]
    assert K.powmod_steps(L).tolist() == [
        max(sum(1 for d in row if d) - 1, 0) for row in L.digits.tolist()
    ]


def test_bad_arguments_raise_and_cpu_tensors_never_launch():
    m, xs, eb = _case(256, seed=6)
    ctx = mm.MXUBarrett(m, device="cpu")
    x = _limbs(xs, ctx.prof)
    d = mm._window_digits(torch.as_tensor(eb), 4)
    with pytest.raises(ValueError, match="mode"):
        K.powmod(x, d, ctx._kc, "window")
    with pytest.raises(ValueError, match="comb"):
        K.pack_powmod(x, d, ctx._kc, "comb")
    with pytest.raises(ValueError, match="shared"):
        K.pack_powmod(x, d, ctx._kc, "shared")
    with pytest.raises(TypeError, match="int32"):
        K.pack_powmod(x.long(), d, ctx._kc, "row")
    K.reset_counters()
    with pytest.raises(ValueError, match="powmod kernel"):
        K.powmod_cuda(x, d, ctx._kc, "row")
    assert K.powmod_launches_by_mode_width == {} and K.plain_calls == 0


def test_kernel_matches_plain_on_gpu():
    """Runs only where there is a CUDA card: every mode at the 2048- and
    4096-bit widths, edges included, bit for bit against the plain
    version, and unreduced bases (beyond the plain version's domain)
    against python ints."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    for bits in (2048, 4096):
        m, xs, eb = _case(bits, seed=bits, rows=16, e_bits=72)
        ctx = mm.MXUBarrett(m, device="cuda")
        x = _limbs(xs, ctx.prof).cuda()
        ebt = torch.as_tensor(eb).cuda()
        es = _exps(eb)
        K.reset_counters()
        d4 = mm._window_digits(ebt, 4)
        got = K.powmod_cuda(x, d4, ctx._kc, "row")
        assert torch.equal(got, K.powmod_plain(x, d4, ctx._kc, "row"))
        assert _ints(got, ctx) == [pow(v, e, m) for v, e in zip(xs, es)]
        for e in (0, 1, es[-1], (1 << 200) - 1):
            nw = max(1, -(-e.bit_length() // 4))
            ds = torch.tensor([(e >> (4 * i)) & 15 for i in range(nw)],
                              dtype=torch.int32, device="cuda")
            got = K.powmod_cuda(x, ds, ctx._kc, "shared")
            assert torch.equal(got, K.powmod_plain(x, ds, ctx._kc, "shared"))
            assert _ints(got, ctx) == [pow(v, e, m) for v in xs]
        ctx.powmod_fixed_base(m - 1, ebt)  # builds the table
        tbl = ctx._fb_tables[(m - 1, 9, mm.COMB_W)]
        d8 = mm._window_digits(ebt, 8)
        got = K.powmod_cuda(None, d8, ctx._kc, "comb", tbl)
        assert torch.equal(got, K.powmod_plain(None, d8, ctx._kc, "comb", tbl))
        assert _ints(got, ctx) == [pow(m - 1, e, m) for e in es]
        # unreduced bases: R^occ - 1 and all ones, python ints only
        n = ctx.prof.n_limbs
        wide = [(1 << (7 * ctx.occ)) - 1, (1 << (7 * n)) - 1] * 2
        xw = _limbs(wide, ctx.prof).cuda()
        got = K.powmod_cuda(xw, d4[:4], ctx._kc, "row")
        assert _ints(got, ctx) == [pow(v, e, m) for v, e in zip(wide, es[:4])]
        assert K.powmod_launches_by_mode_width == {
            ("row", n): 2, ("shared", n): 4, ("comb", n): 2,
        }
        assert K.launches == 0
