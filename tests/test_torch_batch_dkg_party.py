"""The port's batched DKG and reshare parties (protocol/batch_dkg.py)
driven by the port's in-process runner.

Wire messages and shares against the JAX parties' committed golden
(``dkg_party_b4.json``: a 2-of-3 DKG of B=4 wallets on each curve, the
secp256k1 one with the 1024-bit fixture's Paillier material and
proofs, then a reshare from node0, node2 to node0, node1), at cohorts 1
and 2. Rewrite the golden with the JAX package (in a child process,
retried once if XLA:CPU crashes; ~10 min on a CPU)::

    JAX_PLATFORMS=cpu python tests/test_torch_batch_dkg_party.py --write-golden
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import pytest
import torch
import torch_golden_writer as gw
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "dkg_party_b4.json"


def _pre():
    from mpcium_tpu_torch.cluster import load_test_preparams

    return load_test_preparams(1024)


def _dkg(kt, ids, B, sid, seed=0, t=1, **kw):
    from mpcium_tpu_torch.protocol.batch_dkg import BatchedDKGParty
    from mpcium_tpu_torch.utils.rng import SeededStream

    pre = _pre()
    return {pid: BatchedDKGParty(sid, pid, ids, t, kt, B,
                                 preparams=pre[pid] if kt == "secp256k1" else None,
                                 min_paillier_bits=1024, rng=SeededStream(seed + i),
                                 device="cpu", **kw)
            for i, pid in enumerate(ids)}


def _recombine(shares, order: int) -> int:
    from mpcium_tpu_torch.core import hostmath as hm

    xs = [s.self_x for s in shares]
    return sum(hm.lagrange_coeff(xs, s.self_x, order) * s.share for s in shares) % order


@pytest.mark.parametrize("cohorts", [1, 2])
def test_parties_match_the_jax_golden(cohorts):
    from mpcium_tpu_torch.protocol.batch_dkg import BatchedDKGParty, BatchedReshareParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import dkg_golden as dg

    want = json.loads(GOLDEN.read_text())["record"]
    got = dg.party_record(BatchedDKGParty, BatchedReshareParty, run_protocol, _pre(), cohorts,
                          device="cpu")
    for kt in dg.CURVES:
        for proto in ("dkg", "reshare"):
            assert [m[:3] for m in got[kt][proto]["wire"]] == \
                [m[:3] for m in want[kt][proto]["wire"]], (kt, proto)
    assert got == want
    assert want["secp256k1"]["reshare"]["shares"]["node2"] is None


def test_dkg_shares_sign_with_the_ports_ecdsa_party():
    """A two-party secp256k1 DKG's output feeds the batched signing
    party directly; every signature verifies on the host."""
    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import BatchedECDSASigningParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils.rng import SeededStream

    ids = ["node0", "node1"]
    B = 2
    dkg = _dkg("secp256k1", ids, B, "bdkg-sign", seed=60)
    run_protocol(dkg)
    digests = [bytes([7 + w]) * 32 for w in range(B)]
    dom = gb.Domains(alpha=600, beta_prime=320, gamma_bob=600)
    signers = {pid: BatchedECDSASigningParty("bdkg-sign-2", pid, ids, dkg[pid].result, digests,
                                             dom=dom, rng=SeededStream(70 + i), device="cpu")
               for i, pid in enumerate(ids)}
    run_protocol(signers)
    for pid, p in signers.items():
        assert p.result["ok"].all(), pid
        for w in range(B):
            assert hm.ecdsa_verify(hm.secp_decompress(dkg[pid].result[w].public_key),
                                   int.from_bytes(digests[w], "big"),
                                   int.from_bytes(p.result["r"][w].tobytes(), "big"),
                                   int.from_bytes(p.result["s"][w].tobytes(), "big"))


def test_reshare_2_of_3_to_2_of_4_preserves_the_keys():
    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.protocol.batch_dkg import BatchedReshareParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils.rng import SeededStream

    ids = ["node0", "node1", "node2"]
    new_ids = ids + ["node3"]
    B = 2
    dkg = _dkg("ed25519", ids, B, "bdkg-rs", seed=80)
    run_protocol(dkg)
    old_quorum = ["node0", "node1"]
    pubs = [s.public_key for s in dkg["node0"].result]
    parties = {pid: BatchedReshareParty(
        "brs-1", pid, "ed25519", old_quorum, new_ids, 2, B,
        old_shares=dkg[pid].result if pid in old_quorum else None, old_public_keys=pubs,
        rng=SeededStream(90 + i), device="cpu") for i, pid in enumerate(new_ids)}
    run_protocol(parties)
    new_shares = [parties[pid].result for pid in new_ids]
    for w in range(B):
        assert {row[w].public_key for row in new_shares} == {pubs[w]}
        assert {row[w].epoch for row in new_shares} == {1}
        for pick in (new_shares[:3], new_shares[1:]):
            secret = _recombine([row[w] for row in pick], hm.ED_L)
            assert hm.ed_compress(hm.ed_mul(secret, hm.ED_B)) == pubs[w]


def _flip_hex(h: str, i: int) -> str:
    b = bytearray(bytes.fromhex(h))
    b[i] ^= 1
    return bytes(b).hex()


def _with(m, **payload):
    from mpcium_tpu_torch.protocol.base import RoundMsg

    return RoundMsg(m.session_id, m.round, m.from_id, {**m.payload, **payload}, m.to)


def _bad_dln(m):
    d = m.payload["dln1"]
    return _with(m, dln1=dict(d, ts=[str(int(d["ts"][0]) + 1)] + d["ts"][1:]))


_CORRUPTIONS = {
    # (curve, round, field edit, error)
    "subshare": ("ed25519", "dkg/b/2/share",
                 lambda m: _with(m, share=_flip_hex(m.payload["share"], 40)),
                 "Feldman VSS share verification failed"),
    "commitment": ("ed25519", "dkg/b/2/reveal",
                   lambda m: _with(m, points=_flip_hex(m.payload["points"], 5)),
                   "dealing decommitment mismatch"),
    "dln proof": ("secp256k1", "dkg/b/1/commit", _bad_dln, r"DLN proof \(h2 = h1\^a\) failed"),
}


@pytest.mark.parametrize("case", sorted(_CORRUPTIONS))
def test_a_corrupted_dealing_names_the_dealer(case):
    from collections import deque

    from mpcium_tpu_torch.protocol.base import ProtocolError

    kt, round_name, corrupt, match = _CORRUPTIONS[case]
    ids = ["node0", "node1", "node2"]
    parties = _dkg(kt, ids, 2, f"bdkg-bad-{kt}", seed=100)
    queue = deque(m for p in parties.values() for m in p.start())
    with pytest.raises(ProtocolError, match=match) as ei:
        while queue:
            m = queue.popleft()
            if m.round == round_name and m.from_id == "node1":
                m = corrupt(m)
            targets = [m.to] if m.to else [p for p in ids if p != m.from_id]
            for t in targets:
                queue.extend(parties[t].receive(m))
    assert ei.value.culprit == "node1"


def test_constructors_check_their_arguments():
    from mpcium_tpu_torch.protocol.base import ProtocolError
    from mpcium_tpu_torch.protocol.batch_dkg import BatchedDKGParty, BatchedReshareParty

    ids = ["node0", "node1"]
    with pytest.raises(ValueError, match="requires preparams"):
        BatchedDKGParty("x", "node0", ids, 1, "secp256k1", 2, device="cpu")
    with pytest.raises(ValueError, match="0 < t < n"):
        BatchedDKGParty("x", "node0", ids, 2, "ed25519", 2, device="cpu")
    with pytest.raises(ProtocolError, match="old public keys required"):
        BatchedReshareParty("x", "node2", "ed25519", ids, ids + ["node2"], 1, 2, device="cpu")
    with pytest.raises(ProtocolError, match="one share per wallet"):
        BatchedReshareParty("x", "node0", "ed25519", ids, ids, 1, 2, device="cpu")
    with pytest.raises(ProtocolError, match="Paillier modulus too small") as ei:
        from mpcium_tpu_torch.protocol.runner import run_protocol

        run_protocol({pid: BatchedDKGParty("x", pid, ids, 1, "secp256k1", 2,
                                           preparams=_pre()[pid], device="cpu")
                      for pid in ids})
    assert ei.value.culprit == "node0"  # node1 checks node0's round 1 first
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedDKGParty("x", "node0", ids, 1, "ed25519", 2)


@pytest.mark.slow
def test_live_jax_parties_match_the_golden():
    assert _jax_case() == json.loads(GOLDEN.read_text())["record"]


def write_golden() -> None:
    from mpcium_tpu_torch.utils import dkg_golden as dg

    record = gw.child_record(__file__)
    GOLDEN.write_text(json.dumps({
        "about": "wire messages and shares of mpcium_tpu.protocol.batch_dkg."
                 "BatchedDKGParty and BatchedReshareParty on the CPU at cohorts "
                 f"{dg.PARTY['cohorts']} (tests/test_torch_batch_dkg_party.py "
                 "--write-golden); parameters in mpcium_tpu_torch/utils/dkg_golden.py",
        "fixture": "test_preparams_1024.json",
        "record": record,
    }, indent=1) + "\n")


def _jax_case() -> dict:
    gw.setup_jax()
    from mpcium_tpu.cluster import load_test_preparams
    from mpcium_tpu.protocol.batch_dkg import BatchedDKGParty, BatchedReshareParty
    from mpcium_tpu.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import dkg_golden as dg

    class DKG(BatchedDKGParty):
        def receive(self, msg):
            gw.jit_relief()
            return super().receive(msg)

    class Reshare(BatchedReshareParty):
        def receive(self, msg):
            gw.jit_relief()
            return super().receive(msg)

    return dg.party_record(DKG, Reshare, run_protocol, load_test_preparams(bits=1024),
                           dg.PARTY["cohorts"])


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--write-golden" in sys.argv:
        write_golden()
    elif "--golden-case" in sys.argv:
        print(json.dumps(_jax_case()))
