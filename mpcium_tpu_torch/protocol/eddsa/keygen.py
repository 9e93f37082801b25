"""Threshold Ed25519 distributed key generation, one wallet per session
(the port's copy of ``mpcium_tpu/protocol/eddsa/keygen.py``).

A three-round Feldman-VSS DKG:

  R1 (broadcast)  hash commitment to this party's Feldman points
  R2a (broadcast) decommitment: C_ik = a_ik·B for the degree-t polynomial
  R2b (unicast)   Shamir share f_i(x_j) for each peer j
  finalize        verify commitments and shares, x_i = Σ_j f_j(x_i),
                  A = Σ_j C_j0, aggregated VSS commitments Σ_j C_jk

``threshold`` = t means t+1 parties sign. Host python ints throughout.
"""
from __future__ import annotations

import secrets
from typing import Dict, List, Sequence

from ...core import hostmath as hm
from .. import commitments as cm
from ..base import KeygenShare, PartyBase, ProtocolError, RoundMsg

R1 = "eddsa/kg/1"
R2_DECOMMIT = "eddsa/kg/2/decommit"
R2_SHARE = "eddsa/kg/2/share"


class EDDSAKeygenParty(PartyBase):
    # everything drawn before or at the last send
    _SNAP_EXTRA = (
        "_sent_r2", "_coeffs", "_shares_out", "_points", "_commitment",
        "_blind",
    )

    def __init__(self, session_id: str, self_id: str, party_ids: Sequence[str],
                 threshold: int, rng=None):
        super().__init__(session_id, self_id, party_ids, rng or secrets)
        if not 0 < threshold < len(party_ids):
            raise ValueError("need 0 < t < n")
        self.threshold = threshold
        self._sent_r2 = False

    # -- round 1 ------------------------------------------------------------

    def start(self) -> List[RoundMsg]:
        t = self.threshold
        secret = self.rng.randbelow(hm.ED_L - 1) + 1
        self._coeffs, shares = hm.shamir_share(
            secret, t, [self.xs[p] for p in self.party_ids], hm.ED_L, rng=self.rng
        )
        self._shares_out = shares
        self._points = [hm.ed_compress(hm.ed_mul(c, hm.ED_B)) for c in self._coeffs]
        self._commitment, self._blind = cm.commit(cm.encode_points(self._points), rng=self.rng)
        return [self.broadcast(R1, {"commitment": self._commitment.hex()})]

    # -- message handling ---------------------------------------------------

    def receive(self, msg: RoundMsg) -> List[RoundMsg]:
        if self.done:
            return []
        self._store(msg)
        out: List[RoundMsg] = []
        others = self.others()
        if not self._sent_r2 and self._round_full(R1, others):
            # everyone committed: safe to reveal
            self._sent_r2 = True
            out.append(self.broadcast(R2_DECOMMIT, {
                "points": [p.hex() for p in self._points],
                "blind": self._blind.hex(),
            }))
            for pid in others:
                out.append(self.unicast(pid, R2_SHARE,
                                        {"share": str(self._shares_out[self.xs[pid]])}))
        if (self._sent_r2 and not self.done and self._round_full(R2_DECOMMIT, others)
                and self._round_full(R2_SHARE, others)):
            self._finalize()
        return out

    # -- finalize -----------------------------------------------------------

    def _finalize(self) -> None:
        t = self.threshold
        decommits = self._round_payloads(R2_DECOMMIT)
        shares = self._round_payloads(R2_SHARE)
        commits = self._round_payloads(R1)

        all_points: Dict[str, List[hm.EdPoint]] = {
            self.self_id: [hm.ed_decompress(p) for p in self._points]
        }
        for pid in self.others():
            pts_hex = decommits[pid]["points"]
            if len(pts_hex) != t + 1:
                raise ProtocolError("wrong VSS commitment count", pid)
            blind = bytes.fromhex(decommits[pid]["blind"])
            pts_bytes = [bytes.fromhex(p) for p in pts_hex]
            if not cm.verify(bytes.fromhex(commits[pid]["commitment"]), blind,
                             cm.encode_points(pts_bytes)):
                raise ProtocolError("decommitment mismatch", pid)
            try:
                all_points[pid] = [hm.ed_decompress(p) for p in pts_bytes]
            except ValueError as e:
                raise ProtocolError(f"bad commitment point: {e}", pid)

        # Feldman shares: s_ji·B == Σ_k x_i^k · C_jk
        x_i = self._shares_out[self.self_x]
        for pid in self.others():
            s = int(shares[pid]["share"])
            if not 0 <= s < hm.ED_L:
                raise ProtocolError("share out of range", pid)
            if not hm.ed_mul(s, hm.ED_B).equals(_eval_commitments(all_points[pid],
                                                                  self.self_x)):
                raise ProtocolError("VSS share verification failed", pid)
            x_i = (x_i + s) % hm.ED_L

        agg: List[hm.EdPoint] = []
        for k in range(t + 1):
            acc = hm.ED_IDENT
            for pid in self.party_ids:
                acc = hm.ed_add(acc, all_points[pid][k])
            agg.append(acc)
        pub = agg[0]
        if pub.equals(hm.ED_IDENT):
            raise ProtocolError("degenerate public key")

        self.result = KeygenShare(
            key_type="ed25519",
            share=x_i,
            self_x=self.self_x,
            public_key=hm.ed_compress(pub),
            vss_commitments=[hm.ed_compress(p) for p in agg],
            participants=list(self.party_ids),
            threshold=t,
        )
        self.done = True


def _eval_commitments(points: Sequence[hm.EdPoint], x: int) -> hm.EdPoint:
    """Σ_k x^k · C_k (Horner over the group)."""
    acc = hm.ED_IDENT
    for pt in reversed(points):
        acc = hm.ed_add(hm.ed_mul(x, acc), pt)
    return acc
