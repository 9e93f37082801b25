"""The port's snapshot codec (``protocol/base.py``: ``snap_encode``,
``snap_decode``, ``PartyBase.snapshot`` / ``restore``) against the JAX
package's: values and party snapshots are the same JSON in both, a
snapshot taken by either package restores into the other's party, and a
party restored mid-protocol ends with the uninterrupted transcript and
result. The ECDSA runs through a restore are in
``test_torch_session_ecdsa.py`` (against the JAX golden)."""
from __future__ import annotations

import json

import pytest

from mpcium_tpu.core import hostmath as jhm
from mpcium_tpu.core.paillier import PaillierPublicKey as JaxPublicKey
from mpcium_tpu.core.paillier import PreParams as JaxPreParams
from mpcium_tpu.protocol import base as jbase
from mpcium_tpu.protocol.ecdsa import mta as jmta
from mpcium_tpu.protocol.ecdsa.keygen import ECDSAKeygenParty as JaxECDSAKeygen
from mpcium_tpu.protocol.ecdsa.signing import ECDSASigningParty as JaxECDSASigning
from mpcium_tpu.protocol.eddsa.keygen import EDDSAKeygenParty as JaxKeygen
from mpcium_tpu.protocol.eddsa.signing import EDDSASigningParty as JaxSigning
from mpcium_tpu.protocol.resharing import ResharingParty as JaxResharing
from mpcium_tpu_torch.cluster import load_test_preparams
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.core.paillier import PaillierPublicKey
from mpcium_tpu_torch.engine.gg18_batch import dealer_keygen_secp_batch
from mpcium_tpu_torch.protocol import base
from mpcium_tpu_torch.protocol.ecdsa import mta
from mpcium_tpu_torch.protocol.ecdsa.keygen import ECDSAKeygenParty
from mpcium_tpu_torch.protocol.ecdsa.signing import ECDSASigningParty
from mpcium_tpu_torch.protocol.eddsa.keygen import EDDSAKeygenParty
from mpcium_tpu_torch.protocol.eddsa.signing import EDDSASigningParty
from mpcium_tpu_torch.protocol.resharing import ResharingParty
from mpcium_tpu_torch.utils import session_golden as sgo
from mpcium_tpu_torch.utils.rng import SeededStream
from mpcium_tpu_torch.utils.wire_record import digest


def _trip(v):
    return json.loads(json.dumps(v))


def test_snap_codec_roundtrips_through_json():
    v = {
        1: b"\x00\xff",
        "big": 2**521 - 1,
        "neg": -5,
        "tup": (1, (2, b"x")),
        "list": [True, None, 0.5, "s"],
        "nested": {(1, 2): {"k": b""}},
    }
    enc = base.snap_encode(v)
    assert enc == jbase.snap_encode(v)
    out = base.snap_decode(_trip(enc))
    assert out == v == jbase.snap_decode(_trip(enc))
    assert isinstance(out["tup"], tuple)
    assert isinstance(out["tup"][1][1], bytes)
    # non-string dict keys survive the JSON trip
    assert 1 in out and (1, 2) in out["nested"]
    assert isinstance(out["big"], int)


def test_registered_types_are_the_jax_encodings():
    pre = load_test_preparams(2048)
    alice, bob = pre["node0"], pre["node1"]
    pk = alice.paillier.public
    init, _ = mta.mta_init(pk, bob.NTilde, bob.h1, bob.h2, 5, rng=SeededStream(1))
    resp, _ = mta.mta_respond(pk, alice.NTilde, alice.h1, alice.h2, bob.NTilde, bob.h1,
                              bob.h2, init, 7, with_check=True, rng=SeededStream(2))
    share = dealer_keygen_secp_batch(1, sgo.UNIVERSE, 1, rng=SeededStream(3),
                                     preparams=pre)[0][0]
    port = [hm.ed_mul(9, hm.ED_B), hm.secp_mul(9, hm.SECP_G), hm.SECP_INF, pk, alice, share,
            init, resp]
    jax = [jhm.ed_mul(9, jhm.ED_B), jhm.secp_mul(9, jhm.SECP_G), jhm.SECP_INF,
           JaxPublicKey(pk.N), JaxPreParams.from_json(alice.to_json()),
           jbase.KeygenShare.from_json(share.to_json()), jmta.MtaInit.from_json(init.to_json()),
           jmta.MtaResp.from_json(resp.to_json())]
    names = ["edpoint", "secppoint", "secppoint", "paillier_pk", "preparams", "keygen_share",
             "mta_init", "mta_resp"]
    for p, j, name in zip(port, jax, names):
        enc = base.snap_encode(p)
        assert enc == jbase.snap_encode(j) and enc["__o"][0] == name
        back = base.snap_decode(_trip(enc))
        assert type(back) is type(p)
        assert base.snap_encode(back) == enc
    assert base.snap_decode(_trip(base.snap_encode(port[2]))).is_infinity
    assert isinstance(base.snap_decode(base.snap_encode(pk)), PaillierPublicKey)


def test_unknown_values_raise_without_showing_them():
    with pytest.raises(TypeError, match="cannot encode object"):
        base.snap_encode(object())
    with pytest.raises(TypeError, match="unknown type 'nope'"):
        base.snap_decode({"__o": ["nope", "secret-material"]})
    with pytest.raises(TypeError) as e:
        base.snap_decode({"secret": "share-material"})
    assert "share-material" not in str(e.value) and "['secret']" in str(e.value)


def _eddsa_runs():
    """(name, factory, pids) of each EdDSA-side party type:
    ``factory('port' or 'jax')(pid, rng)`` makes that package's party."""
    shares = {}
    for tag, cls in (("port", EDDSAKeygenParty), ("jax", JaxKeygen)):
        parties = {pid: cls("snap-kg", pid, sgo.UNIVERSE, 1, rng=SeededStream(10 + i))
                   for i, pid in enumerate(sgo.UNIVERSE)}
        sgo.run_session(parties)
        shares[tag] = {pid: p.result for pid, p in parties.items()}
    assert {k: v.to_json() for k, v in shares["port"].items()} == \
        {k: v.to_json() for k, v in shares["jax"].items()}
    old, new = ["node0", "node2"], ["node1", "node2", "node3"]
    pub, vss = shares["port"]["node0"].public_key, shares["port"]["node0"].vss_commitments
    return [
        ("keygen", lambda tag: lambda pid, rng: {"port": EDDSAKeygenParty, "jax": JaxKeygen}[tag](
            "snap-kg2", pid, sgo.UNIVERSE, 1, rng=rng), sgo.UNIVERSE),
        ("sign", lambda tag: lambda pid, rng: {"port": EDDSASigningParty, "jax": JaxSigning}[tag](
            "snap-sg", pid, sgo.UNIVERSE, shares[tag][pid], b"snap", rng=rng), sgo.UNIVERSE),
        ("reshare", lambda tag: lambda pid, rng: {"port": ResharingParty, "jax": JaxResharing}[tag](
            "snap-rs", pid, "ed25519", old, new, 1,
            old_share=shares[tag][pid] if pid in old else None, old_public_key=pub,
            old_vss_commitments=vss, rng=rng), sorted(set(old) | set(new))),
    ]


@pytest.mark.parametrize("which", ["keygen", "sign", "reshare"])
def test_eddsa_and_reshare_snapshots_are_the_jax_ones_at_every_point(which):
    name, factory, pids = next(r for r in _eddsa_runs() if r[0] == which)
    port, jax = factory("port"), factory("jax")
    want = sgo.run_session({pid: jax(pid, SeededStream(20 + i)) for i, pid in enumerate(pids)})
    n = len(want[0])
    for k in range(1, n + 1):
        for pid in pids:
            jw, jd = sgo.run_session({q: jax(q, SeededStream(20 + i))
                                      for i, q in enumerate(pids)}, (pid, k))
            pw, pd = sgo.run_session({q: port(q, SeededStream(20 + i))
                                      for i, q in enumerate(pids)}, (pid, k), remake=port)
            assert pd == jd, (name, pid, k)
            assert pw == jw == want[0], (name, pid, k)


def test_a_snapshot_restores_across_the_two_packages():
    """A JAX party's snapshot restored into a port party (and back) goes
    on with the same transcript and signature."""
    _name, factory, pids = next(r for r in _eddsa_runs() if r[0] == "sign")
    port, jax = factory("port"), factory("jax")
    want = sgo.run_session({pid: jax(pid, SeededStream(20 + i)) for i, pid in enumerate(pids)})
    want_sig = None
    for src, dst in ((jax, port), (port, jax)):
        parties = {q: src(q, SeededStream(20 + i)) for i, q in enumerate(pids)}
        got = sgo.run_session(parties, ("node1", 3), remake=dst)
        assert got[0] == want[0]
        assert type(parties["node1"]) is type(dst("node1", None))
        sigs = {p.result for p in parties.values()}
        assert len(sigs) == 1 and want_sig in (None, sigs)
        want_sig = sigs


def test_restore_checks_the_protocol_and_the_session():
    _name, factory, pids = next(r for r in _eddsa_runs() if r[0] == "sign")
    party = factory("port")("node0", SeededStream(1))
    party.start()
    snap = _trip(party.snapshot())
    assert snap["protocol"] == "EDDSASigningParty" and snap["v"] == 1
    other = EDDSAKeygenParty("snap-sg", "node0", sgo.UNIVERSE, 1)
    with pytest.raises(base.ProtocolError, match="restored into EDDSAKeygenParty"):
        other.restore(snap)
    with pytest.raises(base.ProtocolError, match="snapshot for session 'snap-sg'"):
        EDDSASigningParty("elsewhere", "node0", sgo.UNIVERSE, party.share, b"x").restore(snap)


def test_ecdsa_snapshots_after_round_one_are_the_jax_ones():
    """Live at a point each party reaches cheaply: after ``start``, when
    the keygen party has drawn its polynomial and DLN proofs and the
    signing party its nonces and MtA inits."""
    pre = load_test_preparams(1024)
    jpre = {k: JaxPreParams.from_json(v.to_json()) for k, v in pre.items()}
    keygen = {}
    for tag, cls, p in (("port", ECDSAKeygenParty, pre), ("jax", JaxECDSAKeygen, jpre)):
        party = cls("snap-ecdsa-kg", "node1", sgo.UNIVERSE, 1, p["node1"], rng=SeededStream(30),
                    min_paillier_bits=1020)
        party.start()
        keygen[tag] = party.snapshot()
    assert digest(keygen["port"]) == digest(keygen["jax"])
    fresh = ECDSAKeygenParty("snap-ecdsa-kg", "node1", sgo.UNIVERSE, 1, pre["node2"])
    fresh.restore(_trip(keygen["jax"]))
    assert fresh.pre == pre["node1"]  # the material round 1 committed to
    assert digest(fresh.snapshot()) == digest(keygen["port"])

    dealt = dealer_keygen_secp_batch(1, sgo.UNIVERSE, 1, rng=SeededStream(31),
                                     preparams=load_test_preparams(2048))
    share = dealt[1][0]
    signing = {}
    for tag, cls, s in (("port", ECDSASigningParty, share),
                        ("jax", JaxECDSASigning, jbase.KeygenShare.from_json(share.to_json()))):
        party = cls("snap-ecdsa-sg", "node1", ["node1", "node2"], s, 99, rng=SeededStream(32))
        party.start()
        signing[tag] = party.snapshot()
    assert digest(signing["port"]) == digest(signing["jax"])
    fresh = ECDSASigningParty("snap-ecdsa-sg", "node1", ["node1", "node2"], share, 99)
    fresh.restore(_trip(signing["jax"]))
    assert fresh._stage == 1 and digest(fresh.snapshot()) == digest(signing["port"])
