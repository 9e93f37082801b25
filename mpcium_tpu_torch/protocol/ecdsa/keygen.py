"""GG18 ECDSA distributed key generation, one wallet per session
(secp256k1; the port's copy of ``mpcium_tpu/protocol/ecdsa/keygen.py``).

Four rounds:

  R1 (broadcast)  hash commitment to the Feldman VSS points, the Paillier
                  public key, the ring-Pedersen parameters (NTilde, h1,
                  h2) and two DLN proofs
  R2a (unicast)   Shamir share f_i(x_j)
  R2b (broadcast) VSS decommitment
  R3 (broadcast)  Paillier modulus validity proof
  finalize        verify everything; x_i = Σ f_j(x_i), pub = Σ C_j0

The Paillier and NTilde material is the node's :class:`PreParams`, made
once at start-up and passed in. Host python ints throughout.
"""
from __future__ import annotations

import secrets
from typing import Dict, List, Sequence

from ...core import hostmath as hm
from ...core.paillier import PaillierPublicKey, PreParams
from .. import commitments as cm
from ..base import KeygenShare, PartyBase, ProtocolError, RoundMsg
from .zk import DLNProof, PaillierProof, Q

R1 = "ecdsa/kg/1"
R2_SHARE = "ecdsa/kg/2/share"
R2_DECOMMIT = "ecdsa/kg/2/decommit"
R3 = "ecdsa/kg/3"

# minimum Paillier modulus size accepted from peers (tss-lib enforces 2048)
MIN_PAILLIER_BITS = 2046


class ECDSAKeygenParty(PartyBase):
    """One party of the GG18 DKG. ``preparams`` is this node's start-up
    material; ``min_paillier_bits`` is lowered only in tests (small keys)."""

    # "pre" is kept because a restarted node draws FRESH preparams, while
    # round 1 already committed the old ones to the peers
    _SNAP_EXTRA = (
        "_sent_r2", "_sent_r3", "_coeffs", "_shares_out", "_points",
        "_commitment", "_blind", "_peer_pk", "_peer_rp", "pre",
    )

    def __init__(self, session_id: str, self_id: str, party_ids: Sequence[str],
                 threshold: int, preparams: PreParams, rng=None,
                 min_paillier_bits: int = MIN_PAILLIER_BITS):
        super().__init__(session_id, self_id, party_ids, rng or secrets)
        if not 0 < threshold < len(party_ids):
            raise ValueError("need 0 < t < n")
        self.threshold = threshold
        self.pre = preparams
        self.min_paillier_bits = min_paillier_bits
        self._sent_r2 = False
        self._sent_r3 = False

    # -- round 1 ------------------------------------------------------------

    def start(self) -> List[RoundMsg]:
        t = self.threshold
        u = self.rng.randbelow(Q - 1) + 1
        self._coeffs, self._shares_out = hm.shamir_share(
            u, t, [self.xs[p] for p in self.party_ids], Q, rng=self.rng
        )
        self._points = [hm.secp_compress(hm.secp_mul(c, hm.SECP_G)) for c in self._coeffs]
        self._commitment, self._blind = cm.commit(cm.encode_points(self._points), rng=self.rng)
        pre = self.pre
        pq = (pre.P - 1) // 2 * ((pre.Q - 1) // 2)
        bind = self._proof_bind(self.self_id)
        dln1 = DLNProof.prove(pre.h1, pre.h2, pre.alpha, pq, pre.NTilde, self.rng, bind=bind)
        dln2 = DLNProof.prove(pre.h2, pre.h1, pre.beta, pq, pre.NTilde, self.rng, bind=bind)
        return [self.broadcast(R1, {
            "commitment": self._commitment.hex(),
            "paillier_n": str(pre.paillier.N),
            "ntilde": str(pre.NTilde),
            "h1": str(pre.h1),
            "h2": str(pre.h2),
            "dln1": dln1.to_json(),
            "dln2": dln2.to_json(),
        })]

    # -- message handling ---------------------------------------------------

    def receive(self, msg: RoundMsg) -> List[RoundMsg]:
        if self.done:
            return []
        self._store(msg)
        out: List[RoundMsg] = []
        others = self.others()
        if not self._sent_r2 and self._round_full(R1, others):
            self._verify_round1()
            self._sent_r2 = True
            out.append(self.broadcast(R2_DECOMMIT, {
                "points": [p.hex() for p in self._points],
                "blind": self._blind.hex(),
            }))
            for pid in others:
                out.append(self.unicast(pid, R2_SHARE,
                                        {"share": str(self._shares_out[self.xs[pid]])}))
        if (self._sent_r2 and not self._sent_r3 and self._round_full(R2_DECOMMIT, others)
                and self._round_full(R2_SHARE, others)):
            self._sent_r3 = True
            proof = PaillierProof.prove(self.pre.paillier, bind=self._proof_bind(self.self_id))
            out.append(self.broadcast(R3, {"paillier_proof": proof.to_json()}))
        if self._sent_r3 and not self.done and self._round_full(R3, others):
            self._finalize()
        return out

    def _proof_bind(self, sender: str) -> bytes:
        """Session+sender binding of the keygen proofs: a peer cannot
        replay another node's long-lived DLN/Paillier proofs as its own in
        another wallet's keygen."""
        return f"{self.session_id}:{sender}".encode()

    # -- verification -------------------------------------------------------

    def _verify_round1(self) -> None:
        """DLN proofs and parameter sanity for every peer, before round 2
        reveals anything."""
        r1 = self._round_payloads(R1)
        self._peer_pk: Dict[str, PaillierPublicKey] = {}
        self._peer_rp: Dict[str, Dict[str, int]] = {}
        for pid in self.others():
            p = r1[pid]
            N = int(p["paillier_n"])
            ntilde, h1, h2 = int(p["ntilde"]), int(p["h1"]), int(p["h2"])
            if N.bit_length() < self.min_paillier_bits:
                raise ProtocolError("Paillier modulus too small", pid)
            if ntilde.bit_length() < self.min_paillier_bits:
                raise ProtocolError("NTilde too small", pid)
            if h1 in (0, 1) or h2 in (0, 1) or h1 == h2:
                raise ProtocolError("degenerate ring-Pedersen bases", pid)
            bind = self._proof_bind(pid)
            if not DLNProof.from_json(p["dln1"]).verify(h1, h2, ntilde, bind=bind):
                raise ProtocolError("DLN proof (h2 = h1^a) failed", pid)
            if not DLNProof.from_json(p["dln2"]).verify(h2, h1, ntilde, bind=bind):
                raise ProtocolError("DLN proof (h1 = h2^b) failed", pid)
            self._peer_pk[pid] = PaillierPublicKey(N)
            self._peer_rp[pid] = {"ntilde": ntilde, "h1": h1, "h2": h2}

    # -- finalize -----------------------------------------------------------

    def _finalize(self) -> None:
        t = self.threshold
        commits = self._round_payloads(R1)
        decommits = self._round_payloads(R2_DECOMMIT)
        shares = self._round_payloads(R2_SHARE)
        r3 = self._round_payloads(R3)

        all_points: Dict[str, List[hm.SecpPoint]] = {
            self.self_id: [hm.secp_decompress(p) for p in self._points]
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
                all_points[pid] = [hm.secp_decompress(p) for p in pts_bytes]
            except ValueError as e:
                raise ProtocolError(f"bad commitment point: {e}", pid)

        # Paillier validity proofs; a modulus below 2046 bits (the small
        # test keys) gets the structural check only
        for pid in self.others():
            proof = PaillierProof.from_json(r3[pid]["paillier_proof"])
            pk = self._peer_pk[pid]
            if pk.N.bit_length() >= 2046:
                if not proof.verify(pk, bind=self._proof_bind(pid)):
                    raise ProtocolError("Paillier validity proof failed", pid)
            elif not proof.ys:
                raise ProtocolError("missing Paillier proof", pid)

        # Feldman share verification: s_ji·G == Σ x_i^k · C_jk
        x_i = self._shares_out[self.self_x]
        for pid in self.others():
            s = int(shares[pid]["share"])
            if not 0 <= s < Q:
                raise ProtocolError("share out of range", pid)
            if hm.secp_mul(s, hm.SECP_G) != _eval_commitments(all_points[pid], self.self_x):
                raise ProtocolError("VSS share verification failed", pid)
            x_i = (x_i + s) % Q

        agg: List[hm.SecpPoint] = []
        for k in range(t + 1):
            acc = hm.SECP_INF
            for pid in self.party_ids:
                acc = hm.secp_add(acc, all_points[pid][k])
            agg.append(acc)
        pub = agg[0]
        if pub.is_infinity:
            raise ProtocolError("degenerate public key")

        self.result = KeygenShare(
            key_type="secp256k1",
            share=x_i,
            self_x=self.self_x,
            public_key=hm.secp_compress(pub),
            vss_commitments=[hm.secp_compress(p) for p in agg],
            participants=list(self.party_ids),
            threshold=t,
            aux={
                # own secret material
                "paillier_sk": self.pre.paillier.to_json(),
                "preparams": {
                    "ntilde": str(self.pre.NTilde),
                    "h1": str(self.pre.h1),
                    "h2": str(self.pre.h2),
                },
                # the peers' public material, for every signing session
                "peer_paillier": {pid: str(pk.N) for pid, pk in self._peer_pk.items()},
                "peer_ring_pedersen": {
                    pid: {k: str(v) for k, v in rp.items()}
                    for pid, rp in self._peer_rp.items()
                },
            },
        )
        self.done = True


def _eval_commitments(points: Sequence[hm.SecpPoint], x: int) -> hm.SecpPoint:
    """Σ_k x^k · C_k (Horner over the group)."""
    acc = hm.SECP_INF
    for pt in reversed(points):
        acc = hm.secp_add(hm.secp_mul(x, acc), pt)
    return acc
