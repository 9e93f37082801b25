"""The port's batched GG18 ECDSA signing party
(protocol/ecdsa/batch_signing.py) driven by the port's in-process runner.

Wire messages and results against the JAX party's committed golden
(``gg18_party_b4.json``: B=4 on the 1024-bit fixture with shrunk
domains, the same record at cohorts 1 and 2), the quorum material
digest against the JAX package's live, and the party's ProtocolErrors:
mixed material, each constructor check, a wrong-size block and an
equivocating peer (batch abort, culprit named), and a tampered Schnorr
response (only its own lane fails). Rewrite the golden with the JAX
package (each cohort count in a child process, ~20 min on a CPU)::

    JAX_PLATFORMS=cpu python tests/test_torch_gg18_party.py --write-golden
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

torch.set_num_threads(1)  # tiny float64 matmuls: threads only contend

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "gg18_party_b4.json"


def _pre():
    from mpcium_tpu_torch.cluster import load_test_preparams

    return load_test_preparams(1024)


def _dom():
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils import gg18_party_golden as pg

    return gb.Domains(**pg.DOMAINS)


def _shares(B: int, ids, seed: int, preparams=None):
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    return gb.dealer_keygen_secp_batch(B, ids, 1, rng=SeededStream(seed),
                                       preparams=preparams or _pre())


def _party(sid, pid, ids, shares, digests, seed=0, **kw):
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import BatchedECDSASigningParty
    from mpcium_tpu_torch.utils.rng import SeededStream

    return BatchedECDSASigningParty(sid, pid, ids, shares, digests, dom=_dom(),
                                    rng=SeededStream(seed), device="cpu", **kw)


def _assert_verifies(pubs, digests, result) -> None:
    from mpcium_tpu_torch.core import hostmath as hm

    for w, (pub, d) in enumerate(zip(pubs, digests)):
        r = int.from_bytes(bytes.fromhex(result["r"][w]), "big")
        s = int.from_bytes(bytes.fromhex(result["s"][w]), "big")
        assert s <= hm.SECP_N // 2
        assert hm.ecdsa_verify(hm.secp_decompress(bytes.fromhex(pub)),
                               int.from_bytes(bytes.fromhex(d), "big"), r, s), w


@pytest.mark.parametrize("cohorts", [1, 2])
def test_quorum_of_a_2_of_3_universe_matches_the_jax_golden(cohorts):
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import (
        BatchedECDSASigningParty, quorum_material_digest,
    )
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import gg18_party_golden as pg

    want = json.loads(GOLDEN.read_text())["record"]
    got = pg.party_record(gb, BatchedECDSASigningParty, run_protocol, quorum_material_digest,
                          _pre(), cohorts, device="cpu")
    assert [m[:3] for m in got["wire"]] == [m[:3] for m in want["wire"]]
    assert got == want
    for res in got["results"].values():
        assert res["ok"] == [True] * pg.B
        _assert_verifies(want["public_keys"], want["digests"], res)


def test_quorum_material_digest_matches_jax_live():
    from mpcium_tpu.protocol.base import KeygenShare as JaxShare
    from mpcium_tpu.protocol.ecdsa import batch_signing as jbs
    from mpcium_tpu_torch.protocol.ecdsa import batch_signing as bs

    ids = ["node0", "node1", "node2"]
    shares = _shares(1, ids, 41)
    digests = set()
    for i, pid in enumerate(ids):
        s = shares[i][0]
        js = JaxShare.from_json(s.to_json())
        assert bs.share_owner_key(s) == jbs.share_owner_key(js) == pid
        got = bs.quorum_material_digest(s)
        assert got == jbs.quorum_material_digest(js)
        digests.add(got)
    assert len(digests) == 1 and "" not in digests
    bare = _shares(1, ids, 41)[0][0]
    bare.aux = {}
    assert bs.quorum_material_digest(bare) == ""


def test_mixed_material_is_rejected():
    from mpcium_tpu_torch.protocol.base import ProtocolError

    ids = ["node0", "node1"]
    pre = _pre()
    s_a = _shares(1, ids, 43)
    s_b = _shares(1, ids, 44, {"node0": pre["node2"], "node1": pre["node1"]})
    with pytest.raises(ProtocolError, match="mixed Paillier material"):
        _party("gbs-mix", "node0", ids, [s_a[0][0], s_b[0][0]], [b"\x01" * 32, b"\x02" * 32])


def _edit(share, **kw):
    from mpcium_tpu_torch.protocol.base import KeygenShare

    return KeygenShare(**{**share.__dict__, **kw})


_CTOR_CASES = {
    "no aux": (lambda s: [_edit(s[0], aux={}), s[1]], None, "carry no GG18 aux", None),
    "key type": (lambda s: [s[0], _edit(s[1], key_type="ed25519")], None,
                 "wrong key type", None),
    "universe": (lambda s: [s[0], _edit(s[1], participants=["node0", "node1"])], None,
                 "mixed keygen universes", None),
    "threshold": (lambda s: [s[0], _edit(s[1], threshold=2)], None,
                  "mixed threshold/epoch", None),
    "epoch": (lambda s: [s[0], _edit(s[1], epoch=1)], None, "mixed threshold/epoch", None),
    "owner": (lambda s: [s[0], _edit(s[1], self_x=2)], None,
              "does not belong to this node", None),
    "vss": (lambda s: [s[0], _edit(s[1], vss_commitments=s[1].vss_commitments[:1])], None,
            "missing VSS commitments", None),
    "quorum size": (lambda s: s, ["node0"], "not enough participants", None),
    "stranger": (lambda s: s, ["node0", "node9"], "not in keygen universe", "node9"),
    "peer material": (lambda s: [_edit(x, aux={**x.aux, "peer_paillier": {}}) for x in s],
                      None, "missing peer Paillier material", "node1"),
}


@pytest.mark.parametrize("case", sorted(_CTOR_CASES))
def test_constructor_rejects(case):
    from mpcium_tpu_torch.protocol.base import ProtocolError

    edit, quorum, match, culprit = _CTOR_CASES[case]
    own = _shares(2, ["node0", "node1", "node2"], 45)[0]
    with pytest.raises(ProtocolError, match=match) as ei:
        _party("gbs-ctor", "node0", quorum or ["node0", "node1"], edit(own),
               [b"\x01" * 32, b"\x02" * 32])
    assert ei.value.culprit == culprit


def test_constructor_needs_one_share_per_digest():
    own = _shares(2, ["node0", "node1", "node2"], 45)[0]
    with pytest.raises(ValueError, match="one share per digest"):
        _party("gbs-ctor", "node0", ["node0", "node1"], own, [b"\x01" * 32])


def _with(m, **payload):
    from mpcium_tpu_torch.protocol.base import RoundMsg

    return RoundMsg(m.session_id, m.round, m.from_id, {**m.payload, **payload}, m.to)


def test_a_wrong_block_size_or_an_equivocation_aborts_naming_the_peer():
    from mpcium_tpu_torch.protocol.base import ProtocolError
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import R1A, R1B

    ids = ["node0", "node1"]
    shares = _shares(2, ids, 47)
    digests = [b"\x03" * 32, b"\x04" * 32]
    n0 = _party("gbs-abort", "node0", ids, shares[0], digests, seed=1)
    n1 = _party("gbs-abort", "node1", ids, shares[1], digests, seed=2)
    n0.start()
    sent = {m.round: m for m in n1.start()}
    n0.receive(sent[R1B])
    n0.receive(sent[R1B])  # an identical duplicate is legal
    with pytest.raises(ProtocolError, match="equivocation") as ei:
        n0.receive(_with(sent[R1B], gc="00" * 64))
    assert ei.value.culprit == "node1"
    n0b = _party("gbs-abort", "node0", ids, shares[0], digests, seed=1)
    n0b.start()
    n0b.receive(_with(sent[R1B], ck=sent[R1B].payload["ck"][:-2]))
    with pytest.raises(ProtocolError, match="block size") as ei:
        n0b.receive(sent[R1A])
    assert ei.value.culprit == "node1"


def test_a_tampered_schnorr_response_clears_only_its_lane():
    """node1's round-4 PoK response is altered on lane 1 on its way to
    node0: node0 clears that lane and no other; node1, which saw honest
    messages only, signs every lane. The traced run records each round's
    and each party phase's span."""
    from collections import deque

    import numpy as np

    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import R4
    from mpcium_tpu_torch.utils import tracing

    ids = ["node0", "node1"]
    shares = _shares(2, ids, 49)
    digests = [b"\x05" * 32, b"\x06" * 32]
    parties = {pid: _party("gbs-tamper", pid, ids, shares[i], digests, seed=10 + i)
               for i, pid in enumerate(ids)}
    spans = []
    tracing.enable(spans.append)
    try:
        queue = deque(m for p in parties.values() for m in p.start())
        while queue:
            m = queue.popleft()
            to = m.to or next(pid for pid in ids if pid != m.from_id)
            if m.round == R4 and m.from_id == "node1":
                blk = bytearray(bytes.fromhex(m.payload["spok"]))
                blk[32 + 31] ^= 1  # lane 1, last byte of s
                m = _with(m, spok=bytes(blk).hex())
            queue.extend(parties[to].receive(m))
    finally:
        tracing.disable()
    assert parties["node0"].result["ok"].tolist() == [True, False]
    assert parties["node1"].result["ok"].tolist() == [True, True]
    res = parties["node1"].result
    for w in range(2):
        assert hm.ecdsa_verify(hm.secp_decompress(shares[0][w].public_key),
                               int.from_bytes(digests[w], "big"),
                               int.from_bytes(res["r"][w].tobytes(), "big"),
                               int.from_bytes(res["s"][w].tobytes(), "big"))
    assert np.array_equal(parties["node0"].result["r"][0], res["r"][0])
    names = {s["name"] for s in spans}
    assert {"phase:gg18_r1_commit_encrypt_rangeproof", "phase:gg18_respond",
            "phase:gg18_delta", "phase:gg18_phase5a", "phase:gg18_partial",
            "phase:gg18_finalize"} <= names


def test_the_binding_row_is_the_jax_one_and_a_replayed_proof_fails():
    """``_bind_row`` hashes "{session}:{sender}" like the JAX mixin; a
    Schnorr PoK verified under another sender's or session's row fails
    on every lane."""
    import numpy as np

    from mpcium_tpu.protocol.base import BatchBlockMixin as JaxMixin
    from mpcium_tpu_torch.core import bignum as bn
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.protocol.base import BatchBlockMixin

    class Rows(BatchBlockMixin):
        def __init__(self, sid):
            self.session_id, self.B, self.device = sid, 3, torch.device("cpu")

    class JaxRows(JaxMixin):
        def __init__(self, sid):
            self.session_id, self.B = sid, 3

    rows = Rows("gbs-bind")
    assert np.array_equal(rows._bind_row("node1").numpy(),
                          np.asarray(JaxRows("gbs-bind")._bind_row("node1")))
    gamma = torch.as_tensor(bn.batch_to_limbs([5, 6, 7], bn.P256))
    k = torch.as_tensor(bn.batch_to_limbs([11, 12, 13], bn.P256))
    G_pt, G_comp = gb._base_mul_compressed(gamma)
    A, s = gb._blk_schnorr_prove(k, gamma, G_comp, rows._bind_row("node1"))
    verify = lambda bind: gb._blk_schnorr_verify(A, s, G_pt, G_comp, bind).tolist()  # noqa: E731
    assert verify(rows._bind_row("node1")) == [True] * 3
    assert verify(rows._bind_row("node2")) == [False] * 3
    assert verify(Rows("other-session")._bind_row("node1")) == [False] * 3


def test_device_none_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import BatchedECDSASigningParty

    own = _shares(2, ["node0", "node1", "node2"], 45)[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedECDSASigningParty("gbs-dev", "node0", ["node0", "node1"], own,
                                 [b"\x01" * 32] * 2)


@pytest.mark.slow
def test_live_jax_party_matches_the_golden():
    assert _jax_case(1) == json.loads(GOLDEN.read_text())["record"]


def write_golden() -> None:
    """Each cohort count runs in a child process; both counts must give
    the same record."""
    from mpcium_tpu_torch.utils import gg18_party_golden as pg

    records = []
    for k in pg.COHORTS:
        records.append(gw.child_record(__file__, k))
        print(f"cohorts={k} ok={[v['ok'] for v in records[-1]['results'].values()]}",
              flush=True)
    assert all(rec == records[0] for rec in records), "the wire depends on the cohort count"
    GOLDEN.write_text(json.dumps({
        "about": "wire messages and results of mpcium_tpu.protocol.ecdsa.batch_signing."
                 "BatchedECDSASigningParty on the CPU, equal at cohorts "
                 f"{pg.COHORTS} (tests/test_torch_gg18_party.py --write-golden); "
                 "parameters in mpcium_tpu_torch/utils/gg18_party_golden.py",
        "fixture": "test_preparams_1024.json",
        "cohorts": pg.COHORTS,
        "record": records[0],
    }, indent=1) + "\n")


def _jax_case(cohorts: int) -> dict:
    gw.setup_jax()
    from mpcium_tpu.cluster import load_test_preparams
    from mpcium_tpu.engine import gg18_batch as jgb
    from mpcium_tpu.protocol.ecdsa.batch_signing import (
        BatchedECDSASigningParty, quorum_material_digest,
    )
    from mpcium_tpu.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import gg18_party_golden as pg

    class Party(BatchedECDSASigningParty):
        def receive(self, msg):
            gw.jit_relief()
            return super().receive(msg)

    return pg.party_record(jgb, Party, run_protocol, quorum_material_digest,
                           load_test_preparams(bits=1024), cohorts)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--write-golden" in sys.argv:
        write_golden()
    elif "--golden-case" in sys.argv:
        print(json.dumps(_jax_case(int(sys.argv[sys.argv.index("--golden-case") + 1]))))
