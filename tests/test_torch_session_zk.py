"""The port's per-session proofs, MtA and Paillier key generation
(``protocol/ecdsa/zk.py``, ``protocol/ecdsa/mta.py``,
``core/paillier.py``) live against the JAX package's pure-python
modules: the same seeded stream gives the same proofs, messages, primes
and keys as JSON, a proof made by either package verifies in the other,
and every tampered field is rejected by both."""
from __future__ import annotations

import json
import os

import pytest

from mpcium_tpu.core import hostmath as jhm
from mpcium_tpu.core import paillier as jpl
from mpcium_tpu.protocol.ecdsa import mta as jmta
from mpcium_tpu.protocol.ecdsa import zk as jzk
from mpcium_tpu_torch.cluster import load_test_preparams
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.core import paillier as pl
from mpcium_tpu_torch.protocol.ecdsa import mta, zk
from mpcium_tpu_torch.utils.rng import SeededStream

BIND = b"session-zk:node0"
Q = zk.Q


@pytest.fixture(scope="module")
def pre():
    """2048-bit keys: β′ < q⁵ has 1,280 bits and needs the full N."""
    return load_test_preparams(2048)


def _jax_point(P):
    return jhm.SecpPoint(P.x, P.y)


def _both_reject(port_cls, jax_cls, d: dict, *args, **kw) -> None:
    assert not port_cls.from_json(d).verify(*args, **kw)
    assert not jax_cls.from_json(d).verify(*[_jax_arg(a) for a in args],
                                           **{k: _jax_arg(v) for k, v in kw.items()})


def _jax_arg(a):
    if isinstance(a, hm.SecpPoint):
        return _jax_point(a)
    if isinstance(a, pl.PaillierPublicKey):
        return jpl.PaillierPublicKey(a.N)
    return a


def _bumped(d: dict, key: str) -> dict:
    return dict(d, **{key: str(int(d[key]) + 1)})


def test_seeded_schnorr_proof_is_the_jax_json_and_rejects_tampering():
    x = SeededStream(1).randbelow(Q - 1) + 1
    X = hm.secp_mul(x, hm.SECP_G)
    port = zk.SchnorrProof.prove(x, X, rng=SeededStream(2), bind=BIND)
    want = jzk.SchnorrProof.prove(x, _jax_point(X), rng=SeededStream(2), bind=BIND)
    assert port.to_json() == want.to_json()
    assert port.verify(X, bind=BIND)
    assert jzk.SchnorrProof.from_json(port.to_json()).verify(_jax_point(X), bind=BIND)
    d = port.to_json()
    for bad in (_bumped(d, "e"), _bumped(d, "s"), dict(d, s=str(Q)), dict(d, e="-1")):
        _both_reject(zk.SchnorrProof, jzk.SchnorrProof, bad, X, bind=BIND)
    _both_reject(zk.SchnorrProof, jzk.SchnorrProof, d, X, bind=b"session-zk:node1")
    _both_reject(zk.SchnorrProof, jzk.SchnorrProof, d, hm.secp_mul(x + 1, hm.SECP_G), bind=BIND)
    _both_reject(zk.SchnorrProof, jzk.SchnorrProof, d, hm.SECP_INF, bind=BIND)


def test_seeded_pedersen_pok_is_the_jax_json_and_rejects_tampering():
    rng = SeededStream(3)
    a, b = rng.randbelow(Q), rng.randbelow(Q)
    R = hm.secp_mul(7, hm.SECP_G)
    V = hm.secp_add(hm.secp_mul(a, R), hm.secp_mul(b, hm.SECP_G))
    port = zk.PedersenPoK.prove(a, b, R, V, rng=SeededStream(4), bind=BIND)
    want = jzk.PedersenPoK.prove(a, b, _jax_point(R), _jax_point(V), rng=SeededStream(4),
                                 bind=BIND)
    assert port.to_json() == want.to_json()
    assert port.verify(R, V, bind=BIND)
    assert jzk.PedersenPoK.from_json(port.to_json()).verify(_jax_point(R), _jax_point(V),
                                                            bind=BIND)
    d = port.to_json()
    for bad in (_bumped(d, "e"), _bumped(d, "s_a"), _bumped(d, "s_b"), dict(d, s_b=str(Q))):
        _both_reject(zk.PedersenPoK, jzk.PedersenPoK, bad, R, V, bind=BIND)
    _both_reject(zk.PedersenPoK, jzk.PedersenPoK, d, R, V, bind=b"other")
    _both_reject(zk.PedersenPoK, jzk.PedersenPoK, d, R, hm.secp_add(V, hm.SECP_G), bind=BIND)
    _both_reject(zk.PedersenPoK, jzk.PedersenPoK, d, hm.SECP_INF, V, bind=BIND)


def test_seeded_range_proof_alice_is_the_jax_json_and_rejects_tampering(pre):
    alice, bob = pre["node0"], pre["node1"]
    pk = alice.paillier.public
    m = SeededStream(5).randbelow(Q)
    r = zk._rand_unit(pk.N, SeededStream(6))
    assert r == jzk._rand_unit(pk.N, SeededStream(6))
    c = pk.encrypt(m, r=r)
    args = (bob.NTilde, bob.h1, bob.h2, c)
    port = zk.RangeProofAlice.prove(pk, *args, m, r, rng=SeededStream(7))
    want = jzk.RangeProofAlice.prove(jpl.PaillierPublicKey(pk.N), *args, m, r,
                                     rng=SeededStream(7))
    assert port.to_json() == want.to_json()
    assert port.verify(pk, *args)
    assert jzk.RangeProofAlice.from_json(port.to_json()).verify(
        jpl.PaillierPublicKey(pk.N), *args)
    d = port.to_json()
    bads = [_bumped(d, k) for k in ("z", "u", "w", "s", "s1", "s2")]
    bads += [dict(d, s1=str(-int(d["s1"]))), dict(d, s1=str(Q**3 + 1)), dict(d, s2="-1"),
             dict(d, s="0"), dict(d, s=str(pk.N)), dict(d, z=str(bob.NTilde)),
             dict(d, u=str(pk.N2))]
    for bad in bads:
        _both_reject(zk.RangeProofAlice, jzk.RangeProofAlice, bad, pk, *args)
    # the statement: another ciphertext, another verifier's parameters
    _both_reject(zk.RangeProofAlice, jzk.RangeProofAlice, d, pk, *args[:3], c * c % pk.N2)
    _both_reject(zk.RangeProofAlice, jzk.RangeProofAlice, d, pk, pre["node2"].NTilde,
                 pre["node2"].h1, pre["node2"].h2, c)


@pytest.mark.parametrize("with_check", [False, True])
def test_seeded_resp_proof_bob_is_the_jax_json_and_rejects_tampering(pre, with_check):
    alice = pre["node0"]
    pk = alice.paillier.public
    rng = SeededStream(8)
    a, b, beta_prime = rng.randbelow(Q), rng.randbelow(Q), rng.randbelow(Q**5)
    r = zk._rand_unit(pk.N, rng)
    c1 = pk.encrypt(a, r=zk._rand_unit(pk.N, rng))
    c2 = pow(c1, b, pk.N2) * pk.encrypt(beta_prime, r=r) % pk.N2
    X = hm.secp_mul(b, hm.SECP_G) if with_check else None
    rp = (alice.NTilde, alice.h1, alice.h2)
    port = zk.RespProofBob.prove(pk, *rp, c1, c2, b, beta_prime, r, X=X, rng=SeededStream(9))
    want = jzk.RespProofBob.prove(jpl.PaillierPublicKey(pk.N), *rp, c1, c2, b, beta_prime, r,
                                  X=None if X is None else _jax_point(X),
                                  rng=SeededStream(9))
    assert port.to_json() == want.to_json()
    assert port.verify(pk, *rp, c1, c2, X=X)
    assert jzk.RespProofBob.from_json(port.to_json()).verify(
        jpl.PaillierPublicKey(pk.N), *rp, c1, c2, X=None if X is None else _jax_point(X))
    d = port.to_json()
    bads = [_bumped(d, k) for k in ("z", "z_prime", "t", "v", "w", "s", "s1", "s2", "t1",
                                    "t2")]
    bads += [dict(d, s1=str(-int(d["s1"]))), dict(d, t1=str(Q**7 + 1)), dict(d, t2="-1"),
             dict(d, v=str(pk.N2)), dict(d, s=str(pk.N))]
    if with_check:
        bads.append(dict(d, u_point=hm.secp_compress(hm.SECP_G).hex()))
    for bad in bads:
        _both_reject(zk.RespProofBob, jzk.RespProofBob, bad, pk, *rp, c1, c2, X=X)
    if with_check:
        # the bound point: another X, or no X for a with-check proof
        _both_reject(zk.RespProofBob, jzk.RespProofBob, d, pk, *rp, c1, c2,
                     X=hm.secp_mul(b + 1, hm.SECP_G))
        _both_reject(zk.RespProofBob, jzk.RespProofBob, d, pk, *rp, c1, c2)
    else:
        _both_reject(zk.RespProofBob, jzk.RespProofBob, d, pk, *rp, c1, c2, X=hm.SECP_G)


def test_resp_proof_bob_rejects_an_oversized_beta_prime(pre):
    """t1 ≤ q⁷: a β′ near N would make Alice's decryption wrap an oracle
    on k_i; both packages reject the honest proof of such a β′."""
    alice, bob = pre["node0"], pre["node1"]
    pk = alice.paillier.public
    init, _ = mta.mta_init(pk, bob.NTilde, bob.h1, bob.h2, 42, rng=SeededStream(10))
    b = SeededStream(11).randbelow(Q)
    beta_prime = pk.N - Q**6
    r = zk._rand_unit(pk.N, SeededStream(12))
    c_b = pow(init.c_a, b, pk.N2) * pk.encrypt(beta_prime, r=r) % pk.N2
    rp = (alice.NTilde, alice.h1, alice.h2)
    proof = zk.RespProofBob.prove(pk, *rp, init.c_a, c_b, b, beta_prime, r,
                                  rng=SeededStream(13))
    _both_reject(zk.RespProofBob, jzk.RespProofBob, proof.to_json(), pk, *rp, init.c_a, c_b)


@pytest.mark.parametrize("with_check", [False, True])
def test_seeded_mta_round_trip_is_the_jax_one(pre, with_check):
    alice, bob = pre["node0"], pre["node1"]
    rng = SeededStream(14)
    a, b = rng.randbelow(Q), rng.randbelow(Q)
    X = hm.secp_mul(b, hm.SECP_G) if with_check else None
    out = {}
    for tag, m, pk in (("port", mta, alice.paillier.public),
                       ("jax", jmta, jpl.PaillierPublicKey(alice.paillier.N))):
        sk = alice.paillier if tag == "port" else jpl.PaillierPrivateKey(alice.paillier.p,
                                                                        alice.paillier.q)
        init, r_a = m.mta_init(pk, bob.NTilde, bob.h1, bob.h2, a, rng=SeededStream(15))
        resp, beta = m.mta_respond(pk, alice.NTilde, alice.h1, alice.h2, bob.NTilde, bob.h1,
                                   bob.h2, init, b, with_check=with_check,
                                   rng=SeededStream(16))
        point = X if tag == "port" or X is None else _jax_point(X)
        alpha = m.mta_finalize(sk, alice.NTilde, alice.h1, alice.h2, init, resp, X=point)
        out[tag] = (json.dumps(init.to_json()), r_a, json.dumps(resp.to_json()), beta, alpha)
        # the round trip from the JSON forms is the same message
        assert m.MtaResp.from_json(resp.to_json()) == resp
    assert out["port"] == out["jax"]
    _, _, _, beta, alpha = out["port"]
    assert (alpha + beta) % Q == a * b % Q


def test_mta_finalize_binds_the_point_and_respond_checks_alice(pre):
    alice, bob = pre["node0"], pre["node1"]
    pk = alice.paillier.public
    b = 12345
    init, _ = mta.mta_init(pk, bob.NTilde, bob.h1, bob.h2, 777, rng=SeededStream(17))
    resp, _ = mta.mta_respond(pk, alice.NTilde, alice.h1, alice.h2, bob.NTilde, bob.h1,
                              bob.h2, init, b, with_check=True, rng=SeededStream(18))
    jinit, jresp = jmta.MtaInit.from_json(init.to_json()), jmta.MtaResp.from_json(resp.to_json())
    jsk = jpl.PaillierPrivateKey(alice.paillier.p, alice.paillier.q)
    wrong = hm.secp_mul(b + 1, hm.SECP_G)
    with pytest.raises(ValueError, match="Bob's response proof failed"):
        mta.mta_finalize(alice.paillier, alice.NTilde, alice.h1, alice.h2, init, resp, X=wrong)
    with pytest.raises(ValueError, match="Bob's response proof failed"):
        jmta.mta_finalize(jsk, alice.NTilde, alice.h1, alice.h2, jinit, jresp,
                          X=_jax_point(wrong))
    # Alice's proof is checked under Bob's parameters: node2's fail it
    other = pre["node2"]
    for m, i in ((mta, init), (jmta, jinit)):
        with pytest.raises(ValueError, match="Alice's range proof failed"):
            m.mta_respond(_jax_arg(pk) if m is jmta else pk, alice.NTilde, alice.h1,
                          alice.h2, other.NTilde, other.h1, other.h2, i, b,
                          rng=SeededStream(19))


def test_host_paillier_operations_are_the_jax_ones(pre):
    sk = pre["node0"].paillier
    pk, jpk = sk.public, jpl.PaillierPublicKey(sk.N)
    assert pk.g == jpk.g == sk.N + 1
    c1 = pk.encrypt(5, rng=SeededStream(20))
    assert c1 == jpk.encrypt(5, rng=SeededStream(20))
    c2 = pk.encrypt(7, r=3)
    assert pk.add(c1, c2) == jpk.add(c1, c2)
    assert sk.decrypt(pk.add(c1, c2)) == 12
    assert pk.scalar_mul(c1, 9) == jpk.scalar_mul(c1, 9)
    assert sk.decrypt(pk.scalar_mul(c1, 9)) == 45


def test_seeded_prime_search_is_the_jax_one():
    for bits in (32, 64, 128):
        p = pl.gen_prime(bits, SeededStream(bits))
        assert p == jpl.gen_prime(bits, SeededStream(bits))
        assert p.bit_length() == bits and pl.is_probable_prime(p, rng=SeededStream(1))
        s = pl.gen_safe_prime(bits, SeededStream(bits + 1))
        assert s == jpl.gen_safe_prime(bits, SeededStream(bits + 1))
        assert s.bit_length() == bits and pl.is_probable_prime((s - 1) // 2)
    for n in (0, 1, 3, 4, 561, 997, 1009, 2**61 - 1, 2**64 + 1):
        assert pl.is_probable_prime(n, rng=SeededStream(n)) == \
            jpl.is_probable_prime(n, rng=SeededStream(n))


def test_seeded_keys_and_preparams_are_the_jax_ones():
    key = pl.gen_paillier_key(256, SeededStream(30))
    assert key.to_json() == jpl.gen_paillier_key(256, SeededStream(30)).to_json()
    assert key.N.bit_length() == 256 and key.p < key.q
    safe = (pl.gen_safe_prime(128, SeededStream(31)), pl.gen_safe_prime(128, SeededStream(32)))
    got = pl.gen_preparams(256, SeededStream(33), safe_primes=safe)
    assert got.to_json() == jpl.gen_preparams(256, SeededStream(33), safe_primes=safe).to_json()
    assert got.NTilde == safe[0] * safe[1]
    pq = (got.P - 1) // 2 * ((got.Q - 1) // 2)
    assert pow(got.h1, got.alpha, got.NTilde) == got.h2
    assert pow(got.h2, got.beta, got.NTilde) == got.h1
    assert got.alpha * got.beta % pq == 1
    # the whole search, at a small size
    full = pl.gen_preparams(128, SeededStream(34))
    assert full.to_json() == jpl.gen_preparams(128, SeededStream(34)).to_json()


def test_safe_prime_pool_is_the_jax_one(tmp_path):
    port_path, jax_path = tmp_path / "port.json", tmp_path / "jax.json"
    assert pl.pool_fill(port_path, 3, bits=64, rng=SeededStream(40)) == 3
    assert jpl.pool_fill(jax_path, 3, bits=64, rng=SeededStream(40)) == 3
    assert json.loads(port_path.read_text()) == json.loads(jax_path.read_text())
    assert os.stat(port_path).st_mode & 0o777 == 0o600
    assert pl.pool_fill(port_path, 3, bits=64, rng=SeededStream(41)) == 0  # already full
    pool = [int(p) for p in json.loads(port_path.read_text())["safe_primes"]]
    # preparams from the pool take its first two primes and leave the rest
    pre = pl.gen_preparams(128, SeededStream(42), pool_path=port_path)
    jpre = jpl.gen_preparams(128, SeededStream(42), pool_path=jax_path)
    assert pre.to_json() == jpre.to_json() and (pre.P, pre.Q) == tuple(pool[:2])
    assert json.loads(port_path.read_text()) == json.loads(jax_path.read_text())
    # a short pool is topped up by the search, a missing one is all search
    took = pl.pool_take(port_path, count=3, bits=64, rng=SeededStream(43))
    assert took == jpl.pool_take(jax_path, count=3, bits=64, rng=SeededStream(43))
    assert took[0] == pool[2] and json.loads(port_path.read_text())["safe_primes"] == []
    assert pl.pool_take(tmp_path / "none.json", count=1, bits=64, rng=SeededStream(44)) == \
        [pl.gen_safe_prime(64, SeededStream(44))]
    with pytest.raises(ValueError, match="bit-size"):
        pl.pool_take(jax_path, count=1, bits=128, rng=SeededStream(45))
