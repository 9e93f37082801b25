"""The port's limb arithmetic, secp256k1 field and curve against the JAX
package and the python-int hostmath reference. Exact equality.

Tier-1 runs the python-int / hostmath half of each check, and the JAX
half of the encode/decode check (field square roots included); the JAX
half of the others (jit-compiled scans, tens of seconds on a CPU) is the
slow-tier variant of the same test. Field elements are only weakly normalized inside the port (limbs below
2^13, value congruent mod p), so field and curve results are compared
through their canonical limbs, affine points and encodings — every value
the signing engine lets out of the curve module.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpcium_tpu.core import bignum as jbn
from mpcium_tpu.core import fields as jfields
from mpcium_tpu.core import secp256k1_jax as jsp
from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.core import secp256k1 as sp
from mpcium_tpu_torch.core.fields import secp256k1_field

torch.set_num_threads(1)
CPU = torch.device("cpu")
P256 = bn.P256
N = hm.SECP_N
P = hm.SECP_P
RND = random.Random(17)
# the python-int / hostmath half runs in tier-1; the JAX half compiles
# scans for tens of seconds on a CPU and runs in the slow tier
WITH_JAX = [False, pytest.param(True, marks=pytest.mark.slow)]


def _np(x):
    return bn.limbs_to_numpy(x)


def _j(x):
    return jnp.asarray(_np(x))


def test_carry_with_negative_limbs_matches_jax():
    rows = []
    for _ in range(6):
        v = RND.getrandbits(250)
        limbs = bn.to_limbs(v, P256).astype(np.int64)
        for i in range(21):  # move value between neighbours: negative limbs
            d = RND.randint(-(1 << 17), 1 << 17)
            limbs[i] += d * 4096
            limbs[i + 1] -= d
        rows.append(limbs)
    x = np.asarray(rows, np.int32)
    assert (x < 0).any()
    got = bn.carry(bn.limbs_from_numpy(x, CPU), P256)
    assert np.array_equal(_np(got), np.asarray(jbn.carry(jnp.asarray(x), jbn.P256)))
    assert bn.batch_from_limbs(got, P256) == [bn.from_limbs(r, P256) for r in rows]


def test_compare_and_mul_match_jax():
    vals = [5, 7, 1 << 200, 3, (1 << 263) + 9, (1 << 263) + 9]
    xs = torch.as_tensor(bn.batch_to_limbs(vals, P256))
    ys = torch.as_tensor(bn.batch_to_limbs([7, 5, 1 << 200, 2, (1 << 263) + 8, (1 << 263) + 9], P256))
    assert np.array_equal(_np(bn.compare(xs, ys)), np.asarray(jbn.compare(_j(xs), _j(ys))))
    assert bn.compare(xs, ys).tolist() == [-1, 1, 0, 1, 1, 0]
    prod = bn.mul(xs, ys, P256)
    assert np.array_equal(_np(prod), np.asarray(jbn.mul(_j(xs), _j(ys), jbn.P256)))
    assert np.array_equal(_np(bn.mul_wide(xs, ys, P256)), _np(prod))
    sub = bn.cond_sub(xs, ys, P256)
    assert np.array_equal(_np(sub), np.asarray(jbn.cond_sub(_j(xs), _j(ys), jbn.P256)))


@pytest.mark.parametrize("with_jax", WITH_JAX)
def test_scalar_ring_matches_jax_and_python(with_jax):
    ring = sp.scalar_ring(CPU)
    av = [0, 1, N - 1] + [RND.randrange(N) for _ in range(3)]
    bv = [N - 1, RND.randrange(N), N - 1] + [RND.randrange(N) for _ in range(3)]
    a = torch.as_tensor(bn.batch_to_limbs(av, P256))
    b = torch.as_tensor(bn.batch_to_limbs(bv, P256))
    cases = [
        (ring.mulmod(a, b), lambda j: j.mulmod(_j(a), _j(b)),
         [x * y % N for x, y in zip(av, bv)]),
        (ring.addmod(a, b), lambda j: j.addmod(_j(a), _j(b)),
         [(x + y) % N for x, y in zip(av, bv)]),
        (ring.submod(a, b), lambda j: j.submod(_j(a), _j(b)),
         [(x - y) % N for x, y in zip(av, bv)]),
        (ring.negmod(a), lambda j: j.negmod(_j(a)), [-x % N for x in av]),
        (ring.reduce(bn.mul(a, b, P256)),
         lambda j: j.reduce(jbn.mul(_j(a), _j(b), jbn.P256)),
         [x * y % N for x, y in zip(av, bv)]),
    ]
    for got, ref, ints in cases:
        assert bn.batch_from_limbs(got, P256) == ints
        if with_jax:
            assert np.array_equal(_np(got), np.asarray(ref(jsp.scalar_ring())))
    inv = ring.invmod_prime(a[1:])
    assert bn.batch_from_limbs(inv, P256) == [pow(x, N - 2, N) for x in av[1:]]


@pytest.mark.parametrize("with_jax", WITH_JAX)
def test_field_ops_match_jax_and_python(with_jax):
    F = secp256k1_field(CPU)
    JF = jfields.secp256k1_field()
    xv = [0, 1, P - 1] + [RND.randrange(P) for _ in range(3)]
    yv = [P - 1, 2, P - 1] + [RND.randrange(P) for _ in range(3)]
    x = torch.as_tensor(F.from_ints(xv))
    y = torch.as_tensor(F.from_ints(yv))
    jx, jy = jnp.asarray(JF.from_ints(xv)), jnp.asarray(JF.from_ints(yv))
    cases = [
        (F.mul(x, y), lambda: JF.mul(jx, jy), [a * b % P for a, b in zip(xv, yv)]),
        (F.add(x, y), lambda: JF.add(jx, jy), [(a + b) % P for a, b in zip(xv, yv)]),
        (F.sub(x, y), lambda: JF.sub(jx, jy), [(a - b) % P for a, b in zip(xv, yv)]),
        (F.neg(x), lambda: JF.neg(jx), [-a % P for a in xv]),
        (F.mul_small(x, 21), lambda: JF.mul_small(jx, 21), [21 * a % P for a in xv]),
    ]
    for got, ref, ints in cases:
        assert F.to_ints(got) == ints
        if with_jax:
            assert np.array_equal(_np(F.canonical(got)), np.asarray(JF.canonical(ref())))
    assert F.to_ints(F.inv(x[1:])) == [pow(a, P - 2, P) for a in xv[1:]]
    assert F.eq(F.mul(x, y), F.mul(y, x)).all()


def test_field_weak_form_stays_bounded_at_the_extremes():
    """All-ones limbs (the largest weak input) through every operation:
    limbs stay below 2^13 and values stay right mod p."""
    F = secp256k1_field(CPU)
    w = torch.full((2, 22), 8191.0, dtype=torch.float64)
    wv = bn.from_limbs(np.full(22, 8191), P256)
    for got, ref in [
        (F.mul(w, w), wv * wv), (F.add(w, w), 2 * wv), (F.sub(w, w), 0),
        (F.neg(w), -wv), (F.mul_small(w, 21), 21 * wv),
    ]:
        assert 0 <= float(got.min()) and float(got.max()) < 8192
        assert F.to_ints(got) == [ref % P] * 2


def _points(ks):
    return [hm.secp_mul(k, hm.SECP_G) for k in ks]


def _xy(pts):
    """Affine points of either package as comparable (x, y) tuples."""
    return [(p.x, p.y) for p in pts]


@pytest.mark.parametrize("with_jax", WITH_JAX)
def test_add_double_match_host_and_jax(with_jax):
    ks = [RND.randrange(1, N) for _ in range(3)] + [5, 5]
    ls = [RND.randrange(1, N) for _ in range(3)] + [5, N - 5]  # double, P + (-P)
    A, Bp = sp.from_host(_points(ks)), sp.from_host(_points(ls))
    ref = [hm.secp_add(a, b) for a, b in zip(_points(ks), _points(ls))]
    assert sp.to_host(sp.add(A, Bp)) == ref
    if with_jax:
        jA, jB = jsp.from_host(_points(ks)), jsp.from_host(_points(ls))
        assert _xy(jsp.to_host(jax.jit(jsp.add)(jA, jB))) == _xy(ref)
    assert sp.to_host(sp.double(A)) == [hm.secp_add(p, p) for p in _points(ks)]
    ident = sp.identity((5,), CPU)
    assert sp.to_host(sp.add(A, ident)) == _points(ks)
    pick = torch.tensor([True, False, True, False, True])
    assert sp.to_host(sp.select(pick, A, Bp)) == [
        a if t else b for t, a, b in zip(pick.tolist(), _points(ks), _points(ls))
    ]
    assert sp.to_host(sp.double(ident)) == [hm.SECP_INF] * 5


@pytest.mark.parametrize("with_jax", WITH_JAX)
def test_base_and_scalar_mul_match_host_and_jax(with_jax):
    ks = [0, 1, N - 1, RND.randrange(N)]
    bits = sp.scalars_to_bits(ks)
    G = sp.base_mul(torch.as_tensor(bits))
    assert sp.to_host(G) == [hm.secp_mul(k, hm.SECP_G) for k in ks]
    base = _points([RND.randrange(1, N)])[0]
    Q = sp.scalar_mul(torch.as_tensor(bits), sp.from_host([base] * len(ks)))
    assert sp.to_host(Q) == [hm.secp_mul(k, base) for k in ks]
    if with_jax:
        jG = jax.jit(jsp.base_mul)(jnp.asarray(bits))
        assert _xy(jsp.to_host(jG)) == _xy(sp.to_host(G))
        jQ = jax.jit(jsp.scalar_mul)(jnp.asarray(bits), jsp.from_host([base] * len(ks)))
        assert _xy(jsp.to_host(jQ)) == _xy(sp.to_host(Q))


@pytest.mark.parametrize("with_jax", [False, True])
def test_compress_decompress_x_equal(with_jax):
    ks = [1, N - 1] + [RND.randrange(1, N) for _ in range(2)]
    pts = _points(ks)
    X = sp.from_host(pts)
    enc = sp.compress(X)
    assert [bytes(r.tolist()) for r in enc] == [hm.secp_compress(p) for p in pts]
    if with_jax:
        jenc = np.asarray(jax.jit(jsp.compress)(jsp.from_host(pts)))
        assert np.array_equal(enc.numpy(), jenc)
    xs = sp.x_coordinate(X)
    assert bn.batch_from_limbs(xs, P256) == [p.x for p in pts]
    D, ok = sp.decompress(enc)
    assert ok.all() and sp.to_host(D) == pts
    assert sp.equal(D, X).all() and not sp.equal(D, sp.double(X)).any()
    # invalid encodings: bad tag, x >= p, x with no square root
    bad = enc.clone()
    bad[0, 0] = 5
    bad[1, 1:] = torch.as_tensor(list((P + 1).to_bytes(32, "big")), dtype=torch.uint8)
    x_nr = next(x for x in range(5, 100)
                if pow((x ** 3 + 7) % P, (P - 1) // 2, P) != 1)
    bad[2, 1:] = torch.as_tensor(list(x_nr.to_bytes(32, "big")), dtype=torch.uint8)
    _, ok = sp.decompress(bad)
    assert ok.tolist() == [False, False, False, True]
    if with_jax:
        _, jok = jax.jit(jsp.decompress)(jnp.asarray(bad.numpy()))
        assert np.asarray(jok).tolist() == ok.tolist()
