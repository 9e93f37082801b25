"""The port's DLN and Paillier proofs (protocol/ecdsa/zk.py) live against
the JAX package's pure-python ``protocol/ecdsa/zk.py``: a seeded proof
is the same JSON in both, a proof made by either package verifies in
the other, and a wrong binding, a flipped value or a short proof is
rejected by both."""
from __future__ import annotations

import pytest

from mpcium_tpu.core.paillier import PaillierPublicKey as JaxPublicKey
from mpcium_tpu.protocol.ecdsa import zk as jzk
from mpcium_tpu_torch.cluster import load_test_preparams
from mpcium_tpu_torch.core.paillier import PaillierPublicKey
from mpcium_tpu_torch.protocol.ecdsa import zk
from mpcium_tpu_torch.utils.rng import SeededStream

BIND = b"zk-session:node0"


@pytest.fixture(scope="module", params=[1024, 2048])
def pre(request):
    return load_test_preparams(request.param)["node0"]


def _pq(pre) -> int:
    return (pre.P - 1) // 2 * ((pre.Q - 1) // 2)


def test_seeded_dln_proofs_are_the_jax_json(pre):
    for h1, h2, x in ((pre.h1, pre.h2, pre.alpha), (pre.h2, pre.h1, pre.beta)):
        got = zk.DLNProof.prove(h1, h2, x, _pq(pre), pre.NTilde, SeededStream(5), bind=BIND)
        want = jzk.DLNProof.prove(h1, h2, x, _pq(pre), pre.NTilde, SeededStream(5), bind=BIND)
        assert got.to_json() == want.to_json()
        assert zk._challenge_bits(h1, h2, pre.NTilde, got.alphas, BIND) == \
            jzk._challenge_bits(h1, h2, pre.NTilde, want.alphas, BIND)


def test_dln_proofs_cross_verify_and_reject_tampering(pre):
    port = zk.DLNProof.prove(pre.h1, pre.h2, pre.alpha, _pq(pre), pre.NTilde,
                             SeededStream(6), bind=BIND)
    jax = jzk.DLNProof.from_json(port.to_json())
    assert port.verify(pre.h1, pre.h2, pre.NTilde, bind=BIND)
    assert jax.verify(pre.h1, pre.h2, pre.NTilde, bind=BIND)
    made_by_jax = jzk.DLNProof.prove(pre.h1, pre.h2, pre.alpha, _pq(pre), pre.NTilde,
                                     SeededStream(7), bind=BIND)
    assert zk.DLNProof.from_json(made_by_jax.to_json()).verify(
        pre.h1, pre.h2, pre.NTilde, bind=BIND)
    d = port.to_json()
    flipped_t = dict(d, ts=[str(int(d["ts"][0]) + 1)] + d["ts"][1:])
    flipped_a = dict(d, alphas=d["alphas"][:-1] + [str(int(d["alphas"][-1]) ^ 2)])
    short = dict(d, ts=d["ts"][:-1], alphas=d["alphas"][:-1])
    for bad, bind in ((d, b"zk-session:node1"), (d, b"other-session:node0"),
                      (flipped_t, BIND), (flipped_a, BIND), (short, BIND)):
        assert not zk.DLNProof.from_json(bad).verify(pre.h1, pre.h2, pre.NTilde, bind=bind)
        assert not jzk.DLNProof.from_json(bad).verify(pre.h1, pre.h2, pre.NTilde, bind=bind)
    # the statement matters too: h1 = h2^α does not hold
    assert not port.verify(pre.h2, pre.h1, pre.NTilde, bind=BIND)


def test_paillier_proofs_are_the_jax_json_and_cross_verify(pre):
    port = zk.PaillierProof.prove(pre.paillier, bind=BIND)
    assert port.to_json() == jzk.PaillierProof.prove(pre.paillier, bind=BIND).to_json()
    assert zk._paillier_challenges(pre.paillier.N, BIND) == \
        jzk._paillier_challenges(pre.paillier.N, BIND)
    N = pre.paillier.N
    d = port.to_json()
    bad_y = dict(d, ys=[str(int(d["ys"][0]) + 1)] + d["ys"][1:])
    for ok, proof, bind in ((True, d, BIND), (False, d, b"zk-session:node1"),
                            (False, bad_y, BIND), (False, dict(d, ys=d["ys"][:-1]), BIND)):
        # a modulus below 2046 bits is rejected whatever the proof
        want = ok and N.bit_length() >= 2046
        assert zk.PaillierProof.from_json(proof).verify(PaillierPublicKey(N), bind=bind) is want
        assert jzk.PaillierProof.from_json(proof).verify(JaxPublicKey(N), bind=bind) is want


def test_iteration_counts_are_the_jax_ones():
    assert (zk.DLN_ITERS, zk.PAILLIER_ITERS) == (jzk.DLN_ITERS, jzk.PAILLIER_ITERS)
