"""The port's per-session GG18 parties (``protocol/ecdsa/keygen.py``,
``protocol/ecdsa/signing.py``) and secp256k1 resharing
(``protocol/resharing.py``) against goldens written by the JAX
package's parties, and tampered messages against the JAX parties live.

- Keygen and reshare on the 1024-bit fixture (peers' minimum lowered),
  signing by both quorums on 2048-bit shares dealt with the fixture's
  ``aux``: every wire message, every share (``epoch`` and ``aux``
  included), every signature and one mid-protocol snapshot per run equal
  the JAX golden, while the snapshotted party is replaced by a fresh one
  restored from its snapshot (``utils/session_golden.py``).
- A tampered proof, share, decommitment or partial value is rejected by
  the port's party and by the JAX party restored from the same
  snapshot, with the same message and the same culprit.

Regenerate the golden (the JAX parties, about a minute on the CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_session_ecdsa.py --write-golden
"""
from __future__ import annotations

import json
import os
import sys
from collections import deque
from pathlib import Path

import pytest

if __name__ == "__main__":  # the golden writer runs as a script
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mpcium_tpu.cluster import load_test_preparams as jax_preparams
from mpcium_tpu.core.paillier import PreParams as JaxPreParams
from mpcium_tpu.engine.gg18_batch import dealer_keygen_secp_batch as jax_deal
from mpcium_tpu.protocol.base import KeygenShare as JaxShare
from mpcium_tpu.protocol.base import ProtocolError as JaxProtocolError
from mpcium_tpu.protocol.ecdsa.keygen import ECDSAKeygenParty as JaxKeygen
from mpcium_tpu.protocol.ecdsa.signing import ECDSASigningParty as JaxSigning
from mpcium_tpu.protocol.resharing import ResharingParty as JaxResharing

from mpcium_tpu_torch.cluster import load_test_preparams
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.engine.gg18_batch import dealer_keygen_secp_batch
from mpcium_tpu_torch.protocol.base import ProtocolError, RoundMsg
from mpcium_tpu_torch.protocol.ecdsa import keygen as kg
from mpcium_tpu_torch.protocol.ecdsa import signing as sg
from mpcium_tpu_torch.protocol.ecdsa.zk import Q
from mpcium_tpu_torch.protocol.resharing import ResharingParty
from mpcium_tpu_torch.utils import session_golden as sgo
from mpcium_tpu_torch.utils.rng import SeededStream

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "session_ecdsa.json"


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())["record"]


def test_keygen_and_reshare_match_the_jax_golden_through_a_restore(golden):
    got = sgo.ecdsa_keygen_record(kg.ECDSAKeygenParty, ResharingParty,
                                  load_test_preparams(1024), restore=True)
    want = golden["keygen_reshare"]
    for run in ("keygen", "reshare"):
        for key in ("snapshot", "wire", "shares"):
            assert got[run][key] == want[run][key], (run, key)
    assert got == want
    keygen, reshare = got["keygen"]["shares"], got["reshare"]["shares"]
    pub = keygen["node0"]["public_key"]
    assert {s["public_key"] for s in keygen.values()} == {pub}
    # node2 deals and leaves; the new committee keeps the key at epoch 1
    # with the full GG18 aux of its peers
    assert reshare["node2"] is None
    for pid in sgo.EC["new_committee"]:
        s = reshare[pid]
        assert s["public_key"] == pub and s["epoch"] == 1 and s["aux"]["is_reshared"]
        peers = set(sgo.EC["new_committee"]) - {pid}
        assert set(s["aux"]["peer_paillier"]) == set(s["aux"]["peer_ring_pedersen"]) == peers
    assert len({json.dumps(v) for v in got["reshare"]["new_agg"].values()}) == 1


def test_signing_by_both_quorums_matches_the_jax_golden_through_a_restore(golden):
    got = sgo.ecdsa_sign_record(dealer_keygen_secp_batch, sg.ECDSASigningParty,
                                load_test_preparams(2048), restore=True)
    assert got == golden["sign"]
    pub = hm.secp_decompress(bytes.fromhex(got["public_key"]))
    for rec in got["sign"]:
        sigs = list(rec["signatures"].values())
        assert all(s == sigs[0] for s in sigs)
        assert hm.ecdsa_verify(pub, sgo.EC["digest"] % Q, int(sigs[0]["r"]), int(sigs[0]["s"]))


# ---------------------------------------------------------------------------
# tampered messages: the port's party and the JAX party, each restored from
# the receiver's snapshot just before the tampered delivery, must reject it
# with the same message and culprit
# ---------------------------------------------------------------------------


def _shadow_run(parties, shadows, tampers):
    """Run ``parties`` honestly in the runner's order. At each
    ``tampers`` entry (round, sender, receiver, mutate), clone the
    receiver into a port and a JAX shadow (``shadows(pid, snapshot)``)
    that get the mutated message, then every later message to the
    receiver, until each raises → [(port error, JAX error)] by entry."""
    queue: deque = deque()
    for _pid, p in sorted(parties.items()):
        queue.extend(p.start())
    entries = []
    while queue:
        msg = queue.popleft()
        targets = ([pid for pid in sorted(parties) if pid != msg.from_id]
                   if msg.is_broadcast else [msg.to])
        for pid in targets:
            for i, (rnd, sender, receiver, mutate) in enumerate(tampers):
                if (rnd, sender, receiver) == (msg.round, msg.from_id, pid):
                    bad = RoundMsg(msg.session_id, msg.round, msg.from_id,
                                   mutate(dict(msg.payload)), msg.to)
                    entries.append({"i": i, "pid": pid, "errors": [None, None], "next": bad,
                                    "live": list(shadows(pid, parties[pid].snapshot()))})
            for e in entries:
                if e["pid"] != pid:
                    continue
                m, e["next"] = e["next"] or msg, None
                for k, shadow in enumerate(e["live"]):
                    if shadow is None:
                        continue
                    try:
                        shadow.receive(m)
                    except (ProtocolError, JaxProtocolError) as err:
                        e["errors"][k] = (str(err), err.culprit)
                        e["live"][k] = None
            queue.extend(parties[pid].receive(msg))
    return [tuple(e["errors"]) for e in sorted(entries, key=lambda e: e["i"])]


def _bump_first(d: dict, key: str, field: str) -> dict:
    proof = dict(d[key])
    proof[field] = [str(int(proof[field][0]) + 1)] + proof[field][1:]
    return dict(d, **{key: proof})


def test_tampered_keygen_messages_name_the_culprit_as_jax_does():
    pre = load_test_preparams(1024)
    sid, low = "session-ecdsa-tamper", sgo.EC["min_paillier_bits"]

    def make(cls, pre_of, pid, rng):
        return cls(sid, pid, sgo.UNIVERSE, 1, pre_of(pid), rng=rng, min_paillier_bits=low)

    def shadows(pid, snap):
        pair = (make(kg.ECDSAKeygenParty, pre.get, pid, SeededStream(0)),
                make(JaxKeygen, lambda p: JaxPreParams.from_json(pre[p].to_json()), pid,
                     SeededStream(0)))
        for s in pair:
            s.restore(json.loads(json.dumps(snap)))
        return pair

    tampers = [
        (kg.R1, "node1", "node0", lambda d: _bump_first(d, "dln1", "ts")),
        (kg.R1, "node2", "node1", lambda d: dict(d, paillier_n=str(2**1018 + 1))),
        (kg.R1, "node0", "node2", lambda d: dict(d, h2=d["h1"])),
        (kg.R2_SHARE, "node1", "node2", lambda d: dict(d, share=str(int(d["share"]) + 1))),
        (kg.R2_DECOMMIT, "node2", "node0", lambda d: dict(d, blind="00" * 32)),
        (kg.R3, "node1", "node2", lambda d: dict(d, paillier_proof={"ys": []})),
    ]
    parties = {pid: make(kg.ECDSAKeygenParty, pre.get, pid, SeededStream(sgo.EC["keygen"] + i))
               for i, pid in enumerate(sgo.UNIVERSE)}
    errors = _shadow_run(parties, shadows, tampers)
    want = ["DLN proof (h2 = h1^a) failed", "Paillier modulus too small",
            "degenerate ring-Pedersen bases", "VSS share verification failed",
            "decommitment mismatch", "missing Paillier proof"]
    for i, (_rnd, sender, _receiver, _m) in enumerate(tampers):
        port, jax = errors[i]
        assert port == jax == (f"{want[i]} (culprit: {sender})", sender)


def test_tampered_signing_messages_name_the_culprit_as_jax_does():
    dealt = dealer_keygen_secp_batch(1, sgo.UNIVERSE, 1, rng=SeededStream(sgo.EC["deal"]),
                                     preparams=load_test_preparams(2048))
    shares = {pid: row[0] for pid, row in zip(sgo.UNIVERSE, dealt)}
    quorum, sid, digest = sgo.EC["quorums"][0], "session-ecdsa-sign-tamper", sgo.EC["digest"]

    def shadows(pid, snap):
        pair = (sg.ECDSASigningParty(sid, pid, quorum, shares[pid], digest),
                JaxSigning(sid, pid, quorum, JaxShare.from_json(shares[pid].to_json()), digest))
        for s in pair:
            s.restore(json.loads(json.dumps(snap)))
        return pair

    def bump_proof(resp_key: str, field: str):
        def mutate(d):
            inner = dict(d[resp_key])
            inner["proof"] = dict(inner["proof"], **{field: str(int(inner["proof"][field]) + 1)})
            return dict(d, **{resp_key: inner})
        return mutate

    tampers = [
        (sg.R1_MTA, "node0", "node1", bump_proof("init", "s1")),
        (sg.R2, "node1", "node0", bump_proof("w", "t1")),
        (sg.R3, "node0", "node1", lambda d: dict(d, delta=str(Q))),
        (sg.R4, "node1", "node0", lambda d: dict(d, pok=dict(d["pok"], s="1"))),
        (sg.R6, "node0", "node1", lambda d: dict(d, pok=dict(d["pok"], s_a="1"))),
        (sg.R8, "node1", "node0", lambda d: dict(d, U=d["T"])),
        (sg.R9, "node0", "node1", lambda d: dict(d, s=str(Q))),
    ]
    parties = {pid: sg.ECDSASigningParty(sid, pid, quorum, shares[pid], digest,
                                         rng=SeededStream(sgo.EC["sign"] + i))
               for i, pid in enumerate(quorum)}
    errors = _shadow_run(parties, shadows, tampers)
    want = ["MtA: MtA: Alice's range proof failed",
            "MtA finalize: MtA: Bob's response proof failed", "delta out of range",
            "Γ PoK failed", "V_i PoK failed", "U/T decommitment mismatch",
            "partial s out of range"]
    for i, (_rnd, sender, _receiver, _m) in enumerate(tampers):
        port, jax = errors[i]
        assert port == jax == (f"{want[i]} (culprit: {sender})", sender)
    assert all(p.done for p in parties.values())


def test_constructor_checks_are_the_jax_ones():
    dealt = dealer_keygen_secp_batch(1, sgo.UNIVERSE, 1, rng=SeededStream(1),
                                     preparams=load_test_preparams(1024))
    share = dealt[0][0]
    jshare = JaxShare.from_json(share.to_json())
    for cls, s in ((sg.ECDSASigningParty, share), (JaxSigning, jshare)):
        for quorum, what in ((["node0"], "not enough participants"),
                             (["node0", "node9"], "signer not in keygen participant set")):
            with pytest.raises(Exception, match=what) as e:
                cls("s", "node0", quorum, s, 1)
            assert type(e.value).__name__ == "ProtocolError"
    bad_aux = type(share).from_json(dict(share.to_json(), aux=dict(
        share.aux, peer_paillier={"node2": share.aux["peer_paillier"]["node2"]})))
    with pytest.raises(ProtocolError, match="missing peer Paillier material") as e:
        sg.ECDSASigningParty("s", "node0", ["node0", "node1"], bad_aux, 1)
    assert e.value.culprit == "node1"
    with pytest.raises(ValueError, match="need 0 < t < n"):
        kg.ECDSAKeygenParty("k", "node0", sgo.UNIVERSE, 3, load_test_preparams(1024)["node0"])
    with pytest.raises(ValueError, match="need 0 < t < n"):
        JaxKeygen("k", "node0", sgo.UNIVERSE, 3, None)


@pytest.mark.slow
def test_live_2048_bit_chain_matches_jax():
    """Keygen → sign → reshare → sign at the full 2048-bit key size,
    the port's parties against the JAX parties run live."""
    def chain(keygen_cls, signing_cls, resharing_cls, pre):
        run = sgo.run_session
        parties = {pid: keygen_cls("chain-kg", pid, sgo.UNIVERSE, 1, pre[pid],
                                   rng=SeededStream(100 + i))
                   for i, pid in enumerate(sgo.UNIVERSE)}
        rec = {"keygen": run(parties)[0]}
        shares = {pid: p.result for pid, p in parties.items()}

        def sign(tag, quorum, held, seed):
            signers = {pid: signing_cls(tag, pid, quorum, held[pid], sgo.EC["digest"],
                                        rng=SeededStream(seed + i))
                       for i, pid in enumerate(quorum)}
            return run(signers)[0], {pid: p.result for pid, p in signers.items()}

        rec["sign"] = sign("chain-sign", ["node0", "node1"], shares, 110)
        old = ["node0", "node1"]
        rs = {pid: resharing_cls("chain-rs", pid, "secp256k1", old, sgo.UNIVERSE, 1,
                                 old_share=shares[pid] if pid in old else None,
                                 old_public_key=shares["node0"].public_key,
                                 old_vss_commitments=shares["node0"].vss_commitments,
                                 preparams=pre[pid], rng=SeededStream(120 + i))
              for i, pid in enumerate(sgo.UNIVERSE)}
        rec["reshare"] = run(rs)[0]
        new = {pid: p.result for pid, p in rs.items()}
        rec["shares"] = {pid: s.to_json() for pid, s in new.items()}
        rec["sign_after"] = sign("chain-sign2", ["node1", "node2"], new, 130)
        return rec

    got = chain(kg.ECDSAKeygenParty, sg.ECDSASigningParty, ResharingParty,
                load_test_preparams(2048))
    assert got == chain(JaxKeygen, JaxSigning, JaxResharing, jax_preparams(2048))
    assert all(s["epoch"] == 1 for s in got["shares"].values())


def write_golden() -> None:
    record = {
        "keygen_reshare": sgo.ecdsa_keygen_record(JaxKeygen, JaxResharing, jax_preparams(1024)),
        "sign": sgo.ecdsa_sign_record(jax_deal, JaxSigning, jax_preparams(2048)),
    }
    GOLDEN.write_text(json.dumps({
        "about": "wire messages, shares, signatures and snapshot digests of "
                 "mpcium_tpu.protocol.ecdsa.keygen.ECDSAKeygenParty, "
                 "mpcium_tpu.protocol.resharing.ResharingParty (secp256k1) and "
                 "mpcium_tpu.protocol.ecdsa.signing.ECDSASigningParty on the CPU "
                 "(tests/test_torch_session_ecdsa.py --write-golden); parameters in "
                 "mpcium_tpu_torch/utils/session_golden.py",
        "fixtures": {"keygen_reshare": "test_preparams_1024.json",
                     "sign": "test_preparams.json"},
        "record": record,
    }, indent=1) + "\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--write-golden" in sys.argv:
        write_golden()
