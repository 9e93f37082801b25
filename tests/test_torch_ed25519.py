"""The port's ed25519 field and edwards25519 group (core/fields.py,
core/ed25519.py) against the JAX package on the same numpy inputs, and
against the python-int hostmath reference. Exact equality.

Field elements are only weakly normalized inside the port (limbs below
2^13, value congruent mod p), so results are compared through canonical
limbs, affine points and RFC 8032 encodings. The edge table (decode ok
masks, round trips, products at the edge scalars) is also held against
the committed golden that ``chip_smoke.py`` checks on the card; rewrite
it from the JAX package with::

    JAX_PLATFORMS=cpu python tests/test_torch_ed25519.py --write-golden
"""
import json
import os
import random
import sys
from pathlib import Path
from types import SimpleNamespace

if __name__ == "__main__":  # as a script: the repo root on the path, JAX on the CPU
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpcium_tpu.core import bignum as jbn
from mpcium_tpu.core import ed25519_jax as jed
from mpcium_tpu.core import fields as jfields
from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.core import ed25519 as ed
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.core.fields import ed25519_field
from mpcium_tpu_torch.utils import eddsa_golden as eg

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "ed25519_edges.json"
CPU = torch.device("cpu")
P = hm.ED_P
L = hm.ED_L
RND = random.Random(25519)
# the JAX functions under jit: one compile each, shared by every test
JED = SimpleNamespace(
    decompress=jax.jit(jed.decompress), compress=jax.jit(jed.compress),
    base_mul=jax.jit(jed.base_mul), scalar_mul=jax.jit(jed.scalar_mul),
    add=jax.jit(jed.add), double=jax.jit(jed.double), equal=jax.jit(jed.equal),
    scalars_to_bits=jed.scalars_to_bits,
)
WEAK_ONES = sum(8191 << (12 * i) for i in range(22))  # every limb 2^13 - 1
FIELD_EDGES = [0, 1, P - 1, P, P + 1, 2 * P - 1, 2 * P, (1 << 255) - 1,
               (1 << 256) - 1, (1 << 264) - 1] + [RND.getrandbits(255) for _ in range(3)]


def _weak(vals) -> torch.Tensor:
    """Port field elements: standard limbs, plus the all-ones weak row."""
    x = torch.as_tensor(bn.batch_to_limbs(vals, bn.P256), dtype=torch.float64)
    return torch.cat([x, torch.full((1, 22), 8191.0)])


def _jax_in(vals) -> jnp.ndarray:
    """The same values for the JAX field (normalized, < 2^264: the
    all-ones weak row enters reduced mod p)."""
    return jnp.asarray(jbn.batch_to_limbs(list(vals) + [WEAK_ONES % P], jbn.P256))


# ---------------------------------------------------------------------------
# the k = 255 field
# ---------------------------------------------------------------------------


def test_field_edges_match_jax_and_python():
    F, JF = ed25519_field(CPU), jfields.ed25519_field()
    vals = FIELD_EDGES + [WEAK_ONES]
    x, jx = _weak(FIELD_EDGES), _jax_in(FIELD_EDGES)
    y, jy = x.flip(0), jx[::-1]
    want_mul = [a * b % P for a, b in zip(vals, vals[::-1])]
    assert F.to_ints(F.mul(x, y)) == want_mul == JF.to_ints(JF.mul(jx, jy))
    assert F.to_ints(F.square(x)) == [a * a % P for a in vals] == JF.to_ints(JF.square(jx))
    assert F.to_ints(x) == [a % P for a in vals] == JF.to_ints(jx)
    assert np.array_equal(bn.limbs_to_numpy(F.canonical(x)), np.asarray(JF.canonical(jx)))
    want_sub = [(a - b) % P for a, b in zip(vals, vals[::-1])]
    assert F.to_ints(F.sub(x, y)) == want_sub == JF.to_ints(JF.sub(jx, jy))
    assert F.to_ints(F.add(x, y)) == [(a + b) % P for a, b in zip(vals, vals[::-1])]
    assert F.to_ints(F.neg(x)) == [-a % P for a in vals] == JF.to_ints(JF.neg(jx))
    e = (P - 5) // 8
    assert F.to_ints(F.pow_const(x, e)) == [pow(a, e, P) for a in vals]
    assert F.to_ints(F.pow_const(x, e)) == JF.to_ints(JF.pow_const(jx, e))
    assert F.to_ints(F.inv(x)) == [pow(a, P - 2, P) for a in vals]
    assert F.eq(x, _weak([v % P for v in FIELD_EDGES])).all()


def test_field_outputs_of_weak_inputs_stay_weak():
    F = ed25519_field(CPU)
    x = _weak(FIELD_EDGES)
    for out in (F.mul(x, x), F.add(x, x), F.sub(x, x.flip(0)), F.neg(x),
                F.mul_small(x, 31)):
        assert float(out.max()) < 8192 and float(out.min()) >= 0
        assert bool((out == out.floor()).all())


def test_decompress_square_root_matches_jax_on_random_ys():
    """decompress's ratio root x = sqrt((y² - 1) / (d·y² + 1)) on random
    y of both signs: about half have no root and must fail."""
    ys = [RND.randrange(P) for _ in range(12)]
    encs = [(y | (s << 255)).to_bytes(32, "little") for y in ys for s in (0, 1)]
    enc = _enc_rows(encs)
    pts, ok = ed.decompress(torch.as_tensor(enc))
    jpts, jok = JED.decompress(jnp.asarray(enc))
    assert ok.tolist() == np.asarray(jok).tolist()
    got = [p.affine() for p in ed.to_host(pts)]
    assert got == [p.affine() for p in jed.to_host(jpts)]
    for e, good, xy in zip(encs, ok.tolist(), got):
        try:
            want = hm.ed_decompress(e).affine()
        except ValueError:
            want = (0, 1)
            assert not good
        assert xy == want
    assert 0 < ok.tolist().count(True) < len(encs)


# ---------------------------------------------------------------------------
# decompress / compress
# ---------------------------------------------------------------------------


def _enc_rows(encs) -> np.ndarray:
    return np.stack([np.frombuffer(e, np.uint8) for e in encs])


def test_decompress_edge_table_matches_jax_and_host():
    encs = eg.edge_encodings()
    enc = _enc_rows(encs)
    pts, ok = ed.decompress(torch.as_tensor(enc))
    jpts, jok = JED.decompress(jnp.asarray(enc))
    assert ok.tolist() == np.asarray(jok).tolist()
    got = [p.affine() for p in ed.to_host(pts)]
    assert got == [p.affine() for p in jed.to_host(jpts)]
    for e, good, xy in zip(encs, ok.tolist(), got):
        try:
            want = hm.ed_decompress(e).affine()
        except ValueError:
            want = None
        assert good == (want is not None), e.hex()
        assert xy == (want if good else (0, 1))
    # every y ≥ p and both x = 0 encodings with the sign bit set fail
    assert not any(ok[:38].tolist())
    assert ok.tolist().count(False) == 38 + 4 + 2


def test_compress_matches_rfc8032_and_jax():
    seeds = ["9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
             "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb"]
    pubs = ["d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
            "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c"]
    ks = [hm._ed_secret_scalar(bytes.fromhex(s))[0] for s in seeds]
    bits = ed.scalars_to_bits(ks)
    comp = ed.compress(ed.base_mul(torch.as_tensor(bits))).numpy()
    assert [bytes(r).hex() for r in comp] == pubs
    jcomp = np.asarray(JED.compress(JED.base_mul(jnp.asarray(bits))))
    assert np.array_equal(comp, jcomp)
    # a round trip through the JAX decoder and the port's encoder
    jpts, _ = JED.decompress(jnp.asarray(comp))
    pts = ed.EdPointJ(*(torch.as_tensor(np.array(jed.ed25519_field().canonical(c)),
                                        dtype=torch.float64) for c in jpts))
    assert np.array_equal(ed.compress(pts).numpy(), comp)


# ---------------------------------------------------------------------------
# group law and ladders
# ---------------------------------------------------------------------------


def _host_pts(ks):
    return [hm.ed_mul(k, hm.ED_B) for k in ks]


def test_add_double_equal_match_jax():
    ks1 = [RND.randrange(L) for _ in range(3)] + [0]
    ks2 = [RND.randrange(L) for _ in range(3)] + [5]
    torsion = hm.ed_decompress(eg._enc(0))  # order 4
    h1, h2 = _host_pts(ks1) + [torsion], _host_pts(ks2) + [torsion]
    p1, p2 = ed.from_host(h1), ed.from_host(h2)
    j1, j2 = (jed.from_host([p.affine() for p in h]) for h in (h1, h2))
    s = ed.to_host(ed.add(p1, p2))
    js = jed.to_host(JED.add(j1, j2))
    d = ed.to_host(ed.double(p1))
    jd = jed.to_host(JED.double(j1))
    for a, b, got, jgot, dbl, jdbl in zip(h1, h2, s, js, d, jd):
        assert got.affine() == jgot.affine() == hm.ed_add(a, b).affine()
        assert dbl.affine() == jdbl.affine() == hm.ed_add(a, a).affine()
    q = ed.from_host([h1[0], h2[1], h1[2], h1[3], h1[4]])
    j_q = jed.from_host([p.affine() for p in (h1[0], h2[1], h1[2], h1[3], h1[4])])
    eq = ed.equal(p1, q).tolist()
    assert eq == np.asarray(JED.equal(j1, j_q)).tolist() == [True, False, True, True, True]
    # equality is projective: a scaled representative is the same point
    F = ed25519_field(CPU)
    three = F.const(3, (5,))
    scaled = ed.EdPointJ(*(F.mul(c, three) for c in p1))
    assert ed.equal(p1, scaled).all()
    assert (ed.compress(scaled).numpy() == ed.compress(p1).numpy()).all()


def test_ladders_at_edge_scalars_match_jax_and_the_golden():
    rec = eg.edges_record(ed, torch.as_tensor)
    want = json.loads(GOLDEN.read_text())["record"]
    assert rec == want
    # and the JAX package still writes this golden
    assert eg.edges_record(JED, jnp.asarray) == want
    # host check of the ladders: k·P without reducing k
    bases = [hm.ed_decompress(b) for b in eg._scalar_bases()]
    for i, k in enumerate(eg.EDGE_SCALARS):
        assert rec["base_mul"][i] == hm.ed_compress(hm.ed_mul(k, hm.ED_B)).hex()
        for j, base in enumerate(bases):
            got = rec["scalar_mul"][j * len(eg.EDGE_SCALARS) + i]
            assert got == hm.ed_compress(hm.ed_mul(k, base)).hex()


def test_scalar_mul_broadcasts_one_base_over_the_batch():
    base_k = RND.randrange(L)
    base = ed.from_host([hm.ed_mul(base_k, hm.ED_B)])
    ks = [RND.randrange(L) for _ in range(3)]
    out = ed.to_host(ed.scalar_mul(torch.as_tensor(ed.scalars_to_bits(ks)), base))
    for k, got in zip(ks, out):
        assert got.equals(hm.ed_mul(k * base_k % L, hm.ED_B))


def test_scalar_ring_reduces_wide_inputs_like_jax():
    from mpcium_tpu.engine import eddsa_batch as jeb
    from mpcium_tpu_torch.engine import eddsa_batch as eb

    wide = [0, 1, L - 1, L, (1 << 512) - 1, (1 << 511) + 12345, RND.getrandbits(512)]
    b64 = np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in wide])
    got = eb._reduce_wide(torch.as_tensor(b64))
    assert bn.batch_from_limbs(got, bn.P256) == [v % L for v in wide]
    assert np.array_equal(bn.limbs_to_numpy(got), np.asarray(jeb._reduce_wide(jnp.asarray(b64))))
    assert [bytes(r) for r in bn.limbs_to_bytes_le(got, bn.P256, 32).numpy()] == [
        (v % L).to_bytes(32, "little") for v in wide]


def write_golden() -> None:
    rec = eg.edges_record(JED, jnp.asarray)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps({
        "about": "edwards25519 edge table written by mpcium_tpu.core.ed25519_jax "
                 "on the CPU (tests/test_torch_ed25519.py --write-golden)",
        "record": rec,
    }, indent=1) + "\n")


if __name__ == "__main__" and "--write-golden" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    write_golden()
