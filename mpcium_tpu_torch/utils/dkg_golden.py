"""Records of batched DKG and resharing, in JSON form.

What two implementations must agree on for the same seeded streams:

- the in-process engines (``BatchedDKG`` of a 2-of-3 universe on both
  curves, then ``BatchedReshare`` of its first two members' shares to a
  3-of-5 committee): every share record, public key and aggregated VSS
  commitment, the same at each cohort count;
- the distributed parties (``BatchedDKGParty`` of the same universe on
  both curves, then ``BatchedReshareParty`` from the quorum node0, node2
  to the committee node0, node1, so node2 leaves with no result): every
  wire message in the runner's order and every share.

The wire is recorded by ``wire_record`` (the DLN and Paillier proofs
by their SHA-256), and a share's ``aux`` (the node's Paillier key and
its peers' material) by the SHA-256 of its canonical JSON. The functions take the module or classes under test (the JAX
package's or the port's), so one record format serves the JAX package
on the CPU, the port on the CPU and the port on the card.
"""
from __future__ import annotations

from typing import Dict, List

from .rng import SeededStream
from .wire_record import digest, run_recorded

UNIVERSE = ["node0", "node1", "node2"]
THRESHOLD = 1
B = 4
CURVES = ["ed25519", "secp256k1"]
COHORTS = [1, 2]
ENGINE = {"dkg": {"ed25519": 801, "secp256k1": 802}, "reshare": 811,
          "old_quorum": ["node0", "node1"],
          "new_committee": ["node0", "node1", "node2", "node3", "node4"], "t_new": 2}
# node0 deals and stays, node2 deals and leaves (no result), node1 only
# receives. The committee stays within node0–node2, whose fixture moduli
# are all 1024 bits (node3's NTilde has 1023).
PARTY = {"session": "dkg-golden-b4", "dkg": 820, "reshare": 830, "cohorts": 2,
         "old_quorum": ["node0", "node2"], "new_committee": ["node0", "node1"],
         "t_new": 1, "min_paillier_bits": 1024}


def share_row(s) -> Dict:
    d = s.to_json()
    d["aux"] = digest(d["aux"])
    return d


def shares_rows(party_shares) -> List[List[Dict]]:
    return [[share_row(s) for s in row] for row in party_shares]


def engine_record(dkg, cohorts: int, **kw) -> Dict:
    """``dkg``: the module holding ``BatchedDKG`` and ``BatchedReshare``."""
    rec: Dict = {}
    for kt in CURVES:
        shares = dkg.BatchedDKG(UNIVERSE, THRESHOLD, kt, rng=SeededStream(ENGINE["dkg"][kt]),
                                **kw).run(B, cohorts=cohorts)
        old = [shares[UNIVERSE.index(p)] for p in ENGINE["old_quorum"]]
        new = dkg.BatchedReshare(ENGINE["old_quorum"], old, ENGINE["new_committee"],
                                 ENGINE["t_new"], rng=SeededStream(ENGINE["reshare"]),
                                 **kw).run(cohorts=cohorts)
        rec[kt] = {"dkg": shares_rows(shares), "reshare": shares_rows(new)}
    return rec


def party_record(dkg_party_cls, reshare_party_cls, run_protocol, preparams, cohorts: int,
                 **party_kw) -> Dict:
    """A DKG batch per curve, then a reshare of it; ``preparams`` are the
    1024-bit fixture's (node0–node2)."""
    rec: Dict = {}
    for ci, kt in enumerate(CURVES):
        pre = (lambda pid: preparams[pid]) if kt == "secp256k1" else (lambda pid: None)
        dkg = {
            pid: dkg_party_cls(f"{PARTY['session']}-{kt}", pid, UNIVERSE, THRESHOLD, kt, B,
                               preparams=pre(pid), min_paillier_bits=PARTY["min_paillier_bits"],
                               rng=SeededStream(PARTY["dkg"] + 10 * ci + i), cohorts=cohorts,
                               **party_kw)
            for i, pid in enumerate(UNIVERSE)
        }
        dkg_wire = run_recorded(dkg, run_protocol)
        pubs = [s.public_key for s in dkg[UNIVERSE[0]].result]
        old_q, new_c = PARTY["old_quorum"], PARTY["new_committee"]
        rs = {}
        for i, pid in enumerate(sorted(set(old_q) | set(new_c))):
            rs[pid] = reshare_party_cls(
                f"{PARTY['session']}-{kt}-reshare", pid, kt, old_q, new_c, PARTY["t_new"], B,
                old_shares=dkg[pid].result if pid in old_q else None, old_public_keys=pubs,
                preparams=pre(pid) if pid in new_c else None,
                min_paillier_bits=PARTY["min_paillier_bits"],
                rng=SeededStream(PARTY["reshare"] + 10 * ci + i), cohorts=cohorts, **party_kw)
        rs_wire = run_recorded(rs, run_protocol)
        rec[kt] = {
            "dkg": {"wire": dkg_wire,
                    "shares": {pid: [share_row(s) for s in p.result] for pid, p in dkg.items()},
                    "aux": {pid: p.result[0].aux for pid, p in dkg.items()}},
            "reshare": {"wire": rs_wire,
                        "shares": {pid: None if p.result is None
                                   else [share_row(s) for s in p.result]
                                   for pid, p in rs.items()},
                        "aux": {pid: p.result[0].aux for pid, p in rs.items()
                                if p.result is not None}},
        }
    return rec
