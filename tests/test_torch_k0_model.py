"""The algorithm of kernel K0 (``ops/csrc/mulmod.cu``) on the CPU, through
its word-level model (``tests/torch_k0_model.py``), against python ints.

The kernel has no CPU or interpret mode, so these tests hold its
arithmetic (lanes of W words, CIOS with pending carries, the ballot
carry and borrow lookahead, the entry over all kw words of a row, the
powmod modes and exits) for W = 1..5 with the port's own host constants;
chip_smoke.py holds the kernel itself against the plain version on the
card. Moduli per W: m = 2^(32k) - c (runs of all-ones words), m just
above 2^(32(k-1)) (a top word of 1), and a random m whose k leaves the
upper lanes' words zero.
"""
import random

import pytest

from mpcium_tpu_torch.ops import modmul as mm
from mpcium_tpu_torch.ops import mulmod as K

from torch_k0_model import LANES, MASK, Model, lookahead

WS = [1, 2, 3, 4, 5]
K_FULL = {1: 32, 2: 64, 3: 96, 4: 128, 5: 133}  # W=5: the widest row is 133 words


def _consts(m: int):
    bits = m.bit_length()
    n = mm.profile(bits).n_limbs
    return K.make_consts(m, -(-bits // 7), n, None, None, None, "cpu")


def _moduli(W: int):
    k = K_FULL[W]
    kl = 32 * W if W < 5 else 129
    rnd = random.Random(W)
    bits = 32 * (32 * (W - 1) + 3) - 5 if W > 1 else 256
    return [
        (1 << (32 * k)) - 1,  # every word all ones
        (1 << (32 * k)) - (1 << 32) - 1,
        (1 << (32 * (kl - 1))) + 1,  # top word 1
        rnd.getrandbits(bits) | (1 << (bits - 1)) | 1,
    ]


@pytest.mark.parametrize("W", WS)
def test_widths_and_lanes(W):
    for m in _moduli(W):
        c = _consts(m)
        assert c.w == W and c.k <= 32 * W and c.k <= c.kw <= 136 and c.n <= K.MAX_LIMBS
        M = Model(c)
        assert M.value(M.m_lanes) == m and M.value(M.lanes(m - 1)) == m - 1


@pytest.mark.parametrize("W", WS)
def test_mont_mul_matches_python(W):
    rnd = random.Random(100 + W)
    for m in _moduli(W):
        M = Model(_consts(m))
        rinv = pow(M.R, -1, m)
        pairs = [(m - 1, m - 1), (0, m - 1), (1, m - 1), (m - 1, 1)]
        pairs += [(rnd.randrange(m), rnd.randrange(m)) for _ in range(2)]
        for a, b in pairs:
            got = M.value(M.mont_mul(M.lanes(a), M.lanes(b)))
            assert got == a * b * rinv % m, (hex(m), a, b)


@pytest.mark.parametrize("W", WS)
def test_mulmod_entry_is_exact_for_every_normalized_row(W):
    """The product kernel streams all kw words of both rows, so rows
    above m (R^occ - 1, 2^(32k), all-ones rows of n limbs) stay exact."""
    rnd = random.Random(200 + W)
    for m in _moduli(W):
        c = _consts(m)
        M = Model(c)
        full = (1 << (7 * c.n)) - 1
        occ = (1 << (7 * -(-m.bit_length() // 7))) - 1
        wide = [full, occ] + [1 << (32 * c.k)] * ((1 << (32 * c.k)) <= full)
        vals = [0, 1, m - 1, rnd.randrange(m)] + wide
        pairs = [(full, full), (full, m - 1), (0, full), (1, 1)]
        pairs += [(v, vals[(i + 3) % len(vals)]) for i, v in enumerate(vals)]
        for a, b in pairs:
            assert M.mulmod(a, b) == a * b % m, (hex(m), a, b)


def _digits(e: int, bits: int, nw: int):
    return [(e >> (bits * i)) & ((1 << bits) - 1) for i in range(nw)]


@pytest.mark.parametrize("W", WS)
def test_powmod_window_modes_match_python(W):
    """Row and shared share the kernel's window path (they differ in the
    digits' stride): exponents 0, 1, all ones and random, bases with
    the edges and one unreduced all-ones row."""
    rnd = random.Random(300 + W)
    for m in _moduli(W)[1::2]:
        c = _consts(m)
        M = Model(c)
        full = (1 << (7 * c.n)) - 1
        nw = 3
        cases = [(m - 1, 0), (rnd.randrange(m), 1), (m - 1, (1 << 12) - 1),
                 (full, rnd.getrandbits(12)), (0, 5), (1, 0xF0F)]
        for x, e in cases:
            assert M.powmod(x, _digits(e, 4, nw), "row") == pow(x, e, m), (hex(m), x, e)


@pytest.mark.parametrize("W", WS)
def test_powmod_comb_matches_python(W):
    """The comb multiplies canonical entries and leaves by one product
    with R^nz (the consts' ``exit_words``): nz = 0, 1, 2 and all windows."""
    rnd = random.Random(400 + W)
    for m in _moduli(W)[::3]:
        c = _consts(m)
        M = Model(c)
        nw = 3
        base = rnd.randrange(2, m)
        table = [[pow(base, d << (8 * i), m) for d in range(256)] for i in range(nw)]
        rpow = c.exit_words
        assert tuple(rpow.shape) == (K.COMB_MAX_WINDOWS + 1, c.s)
        rp = [sum((int(w) & MASK) << (32 * j) for j, w in enumerate(r)) for r in rpow.tolist()]
        assert rp[:nw + 1] + rp[-1:] == [pow(M.R, j, m) for j in range(nw + 1)] + [
            pow(M.R, K.COMB_MAX_WINDOWS, m)]
        for e in (0, 1, 1 << 16, (1 << 24) - 1, rnd.getrandbits(24) | 1):
            got = M.powmod(None, _digits(e, 8, nw), "comb", table, rp)
            assert got == pow(base, e, m), (hex(m), e)


def _ripple(g, p):
    carry, out = 0, []
    for gi, pi in zip(g, p):
        out.append(carry)
        carry = 1 if gi else (carry if pi else 0)
    return out, carry


def test_lookahead_equals_a_ripple_carry():
    rnd = random.Random(5)
    cases = [([1] + [0] * 31, [0] + [1] * 31), ([0] * 32, [1] * 32),
             ([0] * 31 + [1], [1] * 31 + [0]), ([1] * 32, [0] * 32)]
    for _ in range(200):
        g = [rnd.random() < 0.3 for _ in range(LANES)]
        p = [not gi and rnd.random() < 0.7 for gi in g]
        cases.append((g, p))
    for g, p in cases:
        assert lookahead(g, p) == _ripple(g, p)


@pytest.mark.parametrize("W", WS)
def test_finish_ripples_carries_and_borrows_across_all_lanes(W):
    """Pending carries into all-ones lanes ripple through the whole warp;
    a value of exactly m leaves 0, one below m is kept."""
    s = 32 * W
    m = (1 << (32 * s)) - 1
    c = K.make_consts(m, -(-(32 * s) // 7), -(-(32 * s) // 7), None, None, None, "cpu")
    M = Model(c)
    ones = [[MASK] * W for _ in range(LANES)]
    # all ones plus a carry pending from lane 0: the value is m + 2^(32W)
    got = M.finish([row[:] for row in ones], [1] + [0] * (LANES - 1))
    assert M.value(got) == 1 << (32 * W)
    # all ones plus 2 pending in every lane but the top one
    pend = [2] * (LANES - 1) + [0]
    val = m + sum(2 << (32 * W * (L + 1)) for L in range(LANES - 1))
    assert M.value(M.finish([row[:] for row in ones], pend)) == val % m
    for v, want in ((m, 0), (m - 1, m - 1), (0, 0)):
        assert M.value(M.finish(M.lanes(v), [0] * LANES)) == want
