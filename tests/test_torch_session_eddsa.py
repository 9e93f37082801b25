"""The port's per-session EdDSA parties (``protocol/eddsa/keygen.py``,
``protocol/eddsa/signing.py``), Ed25519 resharing
(``protocol/resharing.py``) and ``ops.hash_suite.sha512_bytes``,
against the JAX package's parties run live (both are host python and
cheap) and against the committed JAX golden that ``chip_smoke.py``
replays on the card:

- keygen, signing by both quorums, a reshare to a new committee and to
  an overlapping one, and signing after each: every wire message, share
  (``epoch`` included) and signature equals JAX's, with the challenge on
  hashlib and on the device SHA-512 alike;
- a bad sub-share, an equivocating decommitment, a bad redeal and a sign
  below threshold are rejected as JAX rejects them, naming the same
  culprit;
- wallets made per session sign in ``BatchedEDDSASigningParty`` on the
  CPU, every signature verified.

Regenerate the golden (the JAX parties, a second on the CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_session_eddsa.py --write-golden
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from collections import deque
from pathlib import Path

import pytest

if __name__ == "__main__":  # the golden writer runs as a script
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)

from mpcium_tpu.ops.hash_suite import sha512_bytes as jax_sha512_bytes
from mpcium_tpu.protocol.base import ProtocolError as JaxProtocolError
from mpcium_tpu.protocol.eddsa.keygen import EDDSAKeygenParty as JaxKeygen
from mpcium_tpu.protocol.eddsa.signing import EDDSASigningParty as JaxSigning
from mpcium_tpu.protocol.resharing import ResharingParty as JaxResharing
from mpcium_tpu.protocol.runner import run_protocol as jax_run

from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.ops.hash_suite import sha512_bytes
from mpcium_tpu_torch.protocol.base import ProtocolError, RoundMsg
from mpcium_tpu_torch.protocol.eddsa import keygen as kg
from mpcium_tpu_torch.protocol.eddsa import signing as sg
from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
from mpcium_tpu_torch.protocol.resharing import ResharingParty
from mpcium_tpu_torch.protocol.runner import run_protocol
from mpcium_tpu_torch.utils import session_golden as sgo
from mpcium_tpu_torch.utils.rng import SeededStream
from mpcium_tpu_torch.utils.wire_record import run_recorded

GOLDEN = Path(__file__).resolve().parents[1] / "mpcium_tpu_torch" / "data" / "goldens" / \
    "session_eddsa.json"
PORT = (kg.EDDSAKeygenParty, sg.EDDSASigningParty, ResharingParty, run_protocol)
JAX = (JaxKeygen, JaxSigning, JaxResharing, jax_run)


@pytest.fixture(params=["hashlib", "device"])
def challenge(request, monkeypatch):
    """Both challenge paths: hashlib, and the device SHA-512 on the CPU."""
    monkeypatch.setenv(sg.ENV_DEVICE_HASH, "1" if request.param == "device" else "0")
    return request.param


def test_sha512_bytes_is_hashlib_and_the_jax_digest():
    for n in (0, 1, 111, 112, 128, 239, 240):
        msg = bytes((7 * i + n) % 256 for i in range(n))
        got = sha512_bytes(msg, device="cpu")
        assert got == hashlib.sha512(msg).digest() == jax_sha512_bytes(msg)


def test_sha512_bytes_without_a_device_needs_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        sha512_bytes(b"m")


def test_the_golden_run_is_the_jax_parties_live_and_the_port_through_restores(challenge):
    want = json.loads(GOLDEN.read_text())["record"]
    assert sgo.eddsa_record(*JAX[:3]) == want
    assert sgo.eddsa_record(*PORT[:3], restore=True, device="cpu") == want
    assert sgo.eddsa_record(*PORT[:3], device="cpu") == want
    for rec in want["sign"] + [want["sign_after_reshare"]]:
        assert len(set(rec["signatures"].values())) == 1
    pub = bytes.fromhex(want["keygen"]["shares"]["node0"]["public_key"])
    for i, rec in enumerate(want["sign"]):
        sig = bytes.fromhex(next(iter(rec["signatures"].values())))
        assert hm.ed25519_verify(pub, sgo.ED["messages"][i], sig)
    for pid, s in want["reshare"]["shares"].items():
        assert (s is None) == (pid not in sgo.ED["new_committee"])
        assert s is None or (s["epoch"] == 1 and s["public_key"] == pub.hex()
                             and s["aux"] == {"is_reshared": True})


def test_the_runner_order_is_the_session_recorder_order():
    """``run_session`` (the goldens' recorder) delivers as ``run_protocol``."""
    def parties():
        return {pid: kg.EDDSAKeygenParty("order", pid, sgo.UNIVERSE, 1, rng=SeededStream(i))
                for i, pid in enumerate(sgo.UNIVERSE)}

    assert sgo.run_session(parties())[0] == run_recorded(parties(), run_protocol)


def _chain(mods, new_committee, **sign_kw):
    """Keygen (3 of 3 parties, t=1), a sign by node1+node2, a reshare
    from node0+node1 to ``new_committee`` (t=1) and a sign by its last
    two members → the wire and results of every run."""
    keygen_cls, signing_cls, resharing_cls, run = mods
    ids = sgo.UNIVERSE
    kparties = {pid: keygen_cls("chain-kg", pid, ids, 1, rng=SeededStream(200 + i))
                for i, pid in enumerate(ids)}
    rec = {"keygen": run_recorded(kparties, run)}
    shares = {pid: p.result for pid, p in kparties.items()}
    rec["shares"] = {pid: s.to_json() for pid, s in shares.items()}

    def sign(tag, quorum, held, msg, seed):
        signers = {pid: signing_cls(tag, pid, quorum, held[pid], msg, rng=SeededStream(seed + i),
                                    **sign_kw) for i, pid in enumerate(quorum)}
        return run_recorded(signers, run), {pid: p.result.hex() for pid, p in signers.items()}

    rec["sign"] = sign("chain-sign", ["node1", "node2"], shares, b"before", 210)
    old = ["node0", "node1"]
    rs = {pid: resharing_cls("chain-rs", pid, "ed25519", old, new_committee, 1,
                             old_share=shares[pid] if pid in old else None,
                             old_public_key=shares["node0"].public_key,
                             old_vss_commitments=shares["node0"].vss_commitments,
                             rng=SeededStream(220 + i))
          for i, pid in enumerate(sorted(set(old) | set(new_committee)))}
    rec["reshare"] = run_recorded(rs, run)
    new = {pid: p.result for pid, p in rs.items()}
    rec["new_shares"] = {pid: None if s is None else s.to_json() for pid, s in new.items()}
    rec["sign_after"] = sign("chain-sign2", sorted(new_committee)[-2:], new, b"after", 230)
    return rec


@pytest.mark.parametrize("new_committee", [["node5", "node6", "node7"],
                                           ["node1", "node2", "node3", "node4"]],
                         ids=["new", "overlapping"])
def test_keygen_sign_reshare_sign_is_the_jax_chain(new_committee, challenge):
    got = _chain(PORT, new_committee, device="cpu")
    assert got == _chain(JAX, new_committee)
    pub = bytes.fromhex(got["shares"]["node0"]["public_key"])
    sig = bytes.fromhex(next(iter(got["sign_after"][1].values())))
    assert hm.ed25519_verify(pub, b"after", sig)
    for pid, s in got["new_shares"].items():
        assert (s is None) == (pid not in new_committee)
        assert s is None or (s["epoch"] == 1 and s["public_key"] == pub.hex())


# ---------------------------------------------------------------------------
# tampering: each package's parties run the same tampered transcript
# ---------------------------------------------------------------------------


def _tampered(parties, tamper):
    """Run ``parties`` in the runner's order, passing every message
    through ``tamper`` → the (message, culprit) of the ProtocolError."""
    queue: deque = deque()
    for _pid, p in sorted(parties.items()):
        queue.extend(p.start())
    try:
        while queue:
            msg = tamper(queue.popleft())
            targets = ([p for pid, p in sorted(parties.items()) if pid != msg.from_id]
                       if msg.is_broadcast else [parties[msg.to]])
            for t in targets:
                queue.extend(t.receive(msg))
    except (ProtocolError, JaxProtocolError) as e:
        return str(e), e.culprit
    raise AssertionError("tampering went undetected")


def _edit(round_name, sender, field, value, to=None):
    def tamper(msg):
        if msg.round == round_name and msg.from_id == sender and (to is None or msg.to == to):
            payload = dict(msg.payload, **{field: value(msg.payload[field])})
            return RoundMsg(msg.session_id, msg.round, msg.from_id, payload, msg.to)
        return msg
    return tamper


def _both(build, tamper):
    got = [_tampered(build(mods), tamper) for mods in (PORT, JAX)]
    assert got[0] == got[1]
    return got[0]


def _keygen(mods):
    return {pid: mods[0]("kg-bad", pid, sgo.UNIVERSE, 1, rng=SeededStream(300 + i))
            for i, pid in enumerate(sgo.UNIVERSE)}


def _wallet(mods):
    parties = _keygen(mods)
    mods[3](parties)
    return {pid: p.result for pid, p in parties.items()}


def test_a_bad_sub_share_names_its_dealer():
    bump = _edit(kg.R2_SHARE, "node1", "share", lambda v: str((int(v) + 1) % hm.ED_L),
                 to="node0")
    assert _both(_keygen, bump) == ("VSS share verification failed (culprit: node1)", "node1")
    far = _edit(kg.R2_SHARE, "node2", "share", lambda v: str(hm.ED_L))
    assert _both(_keygen, far) == ("share out of range (culprit: node2)", "node2")


def test_a_bad_keygen_decommitment_names_its_sender():
    swap = _edit(kg.R2_DECOMMIT, "node2", "points", lambda v: v[::-1])
    assert _both(_keygen, swap) == ("decommitment mismatch (culprit: node2)", "node2")
    short = _edit(kg.R2_DECOMMIT, "node0", "points", lambda v: v[:1])
    assert _both(_keygen, short) == ("wrong VSS commitment count (culprit: node0)", "node0")


def test_an_equivocating_signing_decommitment_names_its_sender():
    def signers(mods):
        shares = _wallet(mods)
        return {pid: mods[1]("sg-bad", pid, sgo.UNIVERSE, shares[pid], b"m",
                             rng=SeededStream(310 + i))
                for i, pid in enumerate(sgo.UNIVERSE)}

    other_R = hm.ed_compress(hm.ed_mul(12345, hm.ED_B)).hex()
    fake = _edit(sg.R2, "node2", "R", lambda v: other_R)
    assert _both(signers, fake) == ("nonce decommitment mismatch (culprit: node2)", "node2")
    partial = _edit(sg.R3, "node1", "s", lambda v: str(hm.ED_L))
    assert _both(signers, partial) == ("partial signature out of range (culprit: node1)",
                                       "node1")


def test_equivocation_and_a_sign_below_threshold_are_rejected_as_jax_does():
    for mods in (PORT, JAX):
        shares = _wallet(mods)
        p = mods[1]("eq", "node0", ["node0", "node1"], shares["node0"], b"m",
                    rng=SeededStream(1))
        p.start()
        first = RoundMsg("eq", sg.R1, "node1", {"commitment": "00" * 32})
        p.receive(first)
        p.receive(first)  # a duplicate is legal
        with pytest.raises(Exception, match="equivocation in round eddsa/sign/1") as e:
            p.receive(RoundMsg("eq", sg.R1, "node1", {"commitment": "11" * 32}))
        assert e.value.culprit == "node1"
        with pytest.raises(Exception, match="not enough participants for threshold"):
            mods[1]("low", "node0", ["node0"], shares["node0"], b"m")
        with pytest.raises(Exception, match="signer not in keygen participant set") as e:
            mods[1]("out", "node0", ["node0", "node9"], shares["node0"], b"m")
        assert e.value.culprit == "node9"


def test_a_bad_redeal_names_its_dealer():
    def resharers(mods):
        shares = _wallet(mods)
        old, new = ["node0", "node1"], ["node7", "node8"]
        pub, vss = shares["node0"].public_key, shares["node0"].vss_commitments
        return {pid: mods[2]("rs-bad", pid, "ed25519", old, new, 1,
                             old_share=shares[pid] if pid in old else None,
                             old_public_key=pub, old_vss_commitments=vss,
                             rng=SeededStream(320 + i))
                for i, pid in enumerate(old + new)}

    bump = _edit("reshare/2/share", "node1", "share", lambda v: str((int(v) + 1) % hm.ED_L))
    assert _both(resharers, bump) == ("sub-share VSS verification failed (culprit: node1)",
                                      "node1")
    swap = _edit("reshare/2/decommit", "node0", "points", lambda v: v[::-1])
    assert _both(resharers, swap) == ("redeal decommitment mismatch (culprit: node0)", "node0")
    claim = _edit("reshare/1/commit", "node1", "old_participants", lambda v: v[:2])
    assert _both(resharers, claim) == ("inconsistent old-universe claims (culprit: node1)",
                                       "node1")


def test_the_device_challenge_without_a_gpu_raises_and_hashlib_needs_none(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    shares = _wallet(PORT)
    quorum = ["node0", "node1"]

    def run():
        signers = {pid: sg.EDDSASigningParty("dev", pid, quorum, shares[pid], b"m",
                                             rng=SeededStream(i))
                   for i, pid in enumerate(quorum)}
        run_protocol(signers)
        return signers["node0"].result

    monkeypatch.setenv(sg.ENV_DEVICE_HASH, "0")
    assert hm.ed25519_verify(shares["node0"].public_key, b"m", run())
    monkeypatch.setenv(sg.ENV_DEVICE_HASH, "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        run()


def test_per_session_wallets_sign_in_the_batched_party_on_the_cpu():
    """The mixed path: wallets made by EDDSAKeygenParty, one per
    session, signed as one batch by BatchedEDDSASigningParty."""
    B, quorum = 4, ["node0", "node2"]
    wallets = []
    for w in range(B):
        parties = {pid: kg.EDDSAKeygenParty(f"mixed-kg-{w}", pid, sgo.UNIVERSE, 1,
                                            rng=SeededStream(400 + 10 * w + i))
                   for i, pid in enumerate(sgo.UNIVERSE)}
        run_protocol(parties)
        wallets.append({pid: p.result for pid, p in parties.items()})
    msgs = [f"mixed {w}".encode() for w in range(B)]
    signers = {pid: BatchedEDDSASigningParty("mixed-sign", pid, quorum,
                                             [wl[pid] for wl in wallets], msgs,
                                             rng=SeededStream(450 + i), device="cpu")
               for i, pid in enumerate(quorum)}
    run_protocol(signers)
    res = [signers[pid].result for pid in quorum]
    assert all(bool(r["ok"].all()) for r in res)
    sigs = [bytes(row) for row in res[0]["signatures"]]
    assert sigs == [bytes(row) for row in res[1]["signatures"]]
    assert all(hm.ed25519_verify(wl["node0"].public_key, m, s)
               for wl, m, s in zip(wallets, msgs, sigs))


def write_golden() -> None:
    GOLDEN.write_text(json.dumps({
        "about": "wire messages, shares, signatures and snapshot digests of "
                 "mpcium_tpu.protocol.eddsa.keygen.EDDSAKeygenParty, "
                 "mpcium_tpu.protocol.eddsa.signing.EDDSASigningParty and "
                 "mpcium_tpu.protocol.resharing.ResharingParty (ed25519) on the CPU "
                 "(tests/test_torch_session_eddsa.py --write-golden); parameters in "
                 "mpcium_tpu_torch/utils/session_golden.py",
        "record": sgo.eddsa_record(*JAX[:3]),
    }, indent=1) + "\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--write-golden" in sys.argv:
        write_golden()
