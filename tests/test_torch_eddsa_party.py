"""The port's batched EdDSA signing party
(protocol/eddsa/batch_signing.py) driven by the port's in-process runner:
wire messages and results against the JAX party's committed golden
(``eddsa_party_b4.json``, written by ``tests/test_torch_eddsa_batch.py
--write-golden``), the JAX package's own party cases, and every
ProtocolError the constructor and the rounds raise.
"""
import json
from pathlib import Path

import numpy as np
import pytest
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)
import torch

from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.engine import eddsa_batch as eb
from mpcium_tpu_torch.protocol.base import KeygenShare, ProtocolError, RoundMsg
from mpcium_tpu_torch.protocol.eddsa.batch_signing import (
    R1_COMMIT, R2_REVEAL, R3_PARTIAL, BatchedEDDSASigningParty,
)
from mpcium_tpu_torch.protocol.runner import run_protocol
from mpcium_tpu_torch.utils import eddsa_golden as eg
from mpcium_tpu_torch.utils import tracing
from mpcium_tpu_torch.utils.rng import SeededStream

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parents[1] / "mpcium_tpu_torch" / "data" / "goldens" / \
    "eddsa_party_b4.json"


def _party(sid, pid, ids, shares, msgs, seed=0, **kw):
    return BatchedEDDSASigningParty(sid, pid, ids, shares, msgs, rng=SeededStream(seed),
                                    device="cpu", **kw)


def test_quorum_of_a_2_of_3_universe_matches_the_jax_golden():
    want = json.loads(GOLDEN.read_text())["record"]
    got = eg.party_record(eb, BatchedEDDSASigningParty, run_protocol, device="cpu")
    assert [m[:3] for m in got["wire"]] == [m[:3] for m in want["wire"]]
    assert got == want
    for pid, res in got["results"].items():
        assert res["ok"] == [True] * eg.B
        for w, sig in enumerate(res["signatures"]):
            assert hm.ed25519_verify(bytes.fromhex(want["public_keys"][w]),
                                     bytes.fromhex(want["messages"][w]), bytes.fromhex(sig))


def test_three_party_batch_signs_and_verifies():
    ids = ["n0", "n1", "n2"]
    B = 5
    shares = eb.dealer_keygen_batch(B, ids, threshold=2, rng=SeededStream(17))
    messages = [bytes([w]) * (32 + w) for w in range(B)]  # ragged too
    parties = {pid: _party("bs-1", pid, ids, shares[i], messages, seed=20 + i)
               for i, pid in enumerate(ids)}
    run_protocol(parties)
    sigs = parties["n0"].result["signatures"]
    for pid, p in parties.items():
        assert p.result["ok"].all(), pid
        assert np.array_equal(p.result["signatures"], sigs)
    for w in range(B):
        assert hm.ed25519_verify(shares[0][w].public_key, messages[w], sigs[w].tobytes())


def _two_parties(sid="bs-2", B=2):
    ids = ["n0", "n1"]
    shares = eb.dealer_keygen_batch(B, ids, threshold=1, rng=SeededStream(23))
    messages = [bytes([w + 1]) * 32 for w in range(B)]
    return ids, {pid: _party(sid, pid, ids, shares[i], messages, seed=30 + i)
                 for i, pid in enumerate(ids)}


def _deliver(parties, msgs, corrupt=None):
    out = []
    for m in msgs:
        if corrupt is not None:
            m = corrupt(m)
        for pid, p in parties.items():
            if pid != m.from_id:
                out.extend(p.receive(m))
    return out


def _with(m: RoundMsg, **payload) -> RoundMsg:
    return RoundMsg(m.session_id, m.round, m.from_id, {**m.payload, **payload}, m.to)


def test_commitment_fraud_aborts_with_culprit():
    _, parties = _two_parties()
    first = [m for p in parties.values() for m in p.start()]
    second = _deliver(parties, first)
    assert {m.round for m in second} == {R2_REVEAL}

    def flip(m):
        if m.round == R2_REVEAL and m.from_id == "n1":
            blk = bytearray(bytes.fromhex(m.payload["R"]))
            blk[0] ^= 1
            return _with(m, R=bytes(blk).hex())
        return m

    with pytest.raises(ProtocolError, match="nonce commitment fraud") as ei:
        _deliver(parties, second, flip)
    assert ei.value.culprit == "n1"


@pytest.mark.parametrize("round_name", [R2_REVEAL, R3_PARTIAL])
def test_a_wrong_block_size_is_a_protocol_error(round_name):
    _, parties = _two_parties()
    msgs = [m for p in parties.values() for m in p.start()]
    field = "R" if round_name == R2_REVEAL else "s"

    def cut(m):
        if m.round == round_name and m.from_id == "n0":
            return _with(m, **{field: m.payload[field][:-2]})
        return m

    with pytest.raises(ProtocolError, match="block size") as ei:
        while msgs:
            msgs = _deliver(parties, msgs, cut)
    assert ei.value.culprit == "n0"


def test_equivocation_and_strangers_are_protocol_errors():
    _, parties = _two_parties()
    c0 = parties["n0"].start()[0]
    parties["n1"].start()
    parties["n1"].receive(c0)
    parties["n1"].receive(c0)  # an identical duplicate is legal
    with pytest.raises(ProtocolError, match="equivocation") as ei:
        parties["n1"].receive(_with(c0, commit="00" * 32))
    assert ei.value.culprit == "n0"
    with pytest.raises(ProtocolError, match="non-participant"):
        parties["n1"].receive(RoundMsg("bs-2", R1_COMMIT, "n9", {}))
    with pytest.raises(ProtocolError, match="session"):
        parties["n1"].receive(RoundMsg("other", R1_COMMIT, "n0", {}))


def _edit(shares, **kw):
    return [KeygenShare(**{**s.__dict__, **kw}) for s in shares]


def test_constructor_checks_each_wallet():
    ids = ["n0", "n1", "n2"]
    shares = eb.dealer_keygen_batch(2, ids, threshold=1, rng=SeededStream(29))
    msgs = [b"m" * 32] * 2
    cases = [
        (_edit(shares[0], key_type="secp256k1"), ["n0", "n1"], "wrong key type", None),
        (shares[0], ["n0"], "not enough participants", None),
        (shares[0][:1] + _edit(shares[0][1:], participants=["n0", "n2"]),
         ["n0", "n1"], "not in keygen universe", "n1"),
        (shares[1], ["n0", "n1"], "does not belong to this node", None),
    ]
    for sh, quorum, match, culprit in cases:
        with pytest.raises(ProtocolError, match=match) as ei:
            _party("bs-3", "n0", quorum, sh, msgs)
        assert ei.value.culprit == culprit
    with pytest.raises(ValueError, match="one share per message"):
        _party("bs-3", "n0", ["n0", "n1"], shares[0], msgs[:1])


def test_device_none_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    ids = ["n0", "n1"]
    shares = eb.dealer_keygen_batch(2, ids, threshold=1, rng=SeededStream(23))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedEDDSASigningParty("bs-4", "n0", ids, shares[0], [b"m"] * 2)


def test_traced_run_records_round_spans_and_signs_the_same_bytes():
    _, parties = _two_parties("bs-5")
    run_protocol(parties)
    plain = parties["n0"].result["signatures"]
    spans = []
    tracing.enable(spans.append)
    try:
        _, parties = _two_parties("bs-5")
        run_protocol(parties)
    finally:
        tracing.disable()
    assert np.array_equal(parties["n0"].result["signatures"], plain)
    names = {s["name"] for s in spans}
    assert {"round:start", f"round:{R1_COMMIT}", f"round:{R2_REVEAL}",
            f"round:{R3_PARTIAL}", "phase:bsign_nonce_commit",
            "phase:bsign_aggregate_partial", "phase:bsign_combine_verify"} <= names
    assert all(s["t1_ns"] >= s["t0_ns"] > 0 for s in spans)
    assert len({s["trace_id"] for s in spans if s["name"].startswith("round:")}) == 1
    assert not tracing.enabled()
    assert tracing.span("x") is tracing.NOOP_SPAN


@pytest.mark.slow
def test_live_jax_party_matches_the_golden():
    from mpcium_tpu.engine import eddsa_batch as jeb
    from mpcium_tpu.protocol.eddsa.batch_signing import BatchedEDDSASigningParty as JaxParty
    from mpcium_tpu.protocol.runner import run_protocol as jax_run

    want = json.loads(GOLDEN.read_text())["record"]
    assert eg.party_record(jeb, JaxParty, jax_run) == want
