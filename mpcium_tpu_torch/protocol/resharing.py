"""Committee rotation (resharing) of one wallet per session, both curves
(the port's copy of ``mpcium_tpu/protocol/resharing.py``).

An old quorum (≥ t_old+1 holders) re-deals the SAME secret to a new
committee under a new threshold; the public key is unchanged and the
share records move to ``epoch`` + 1. Each old member i deals a fresh
degree-t_new Feldman VSS of its Lagrange-weighted share w_i = λ_i·x_i
(Σ w_i = secret):

  R1  (old, broadcast)  hash commitment to the Feldman points of w_i
  R2a (old, broadcast)  decommitment; C_i0 MUST equal λ_i·X_i, computed
                        from the OLD aggregated VSS commitments, which
                        binds the redeal to the wallet's key
  R2b (old, unicast)    sub-share f_i(x'_j) for each new member j
  R3  (new, broadcast)  confirm: hash of (public key ‖ new commitments)
  finalize              x'_j = Σ_i f_i(x'_j); the public key unchanged

On secp256k1 the new committee also exchanges its Paillier and
ring-Pedersen material, with DLN and Paillier-validity proofs, in R3,
and each new share carries the full GG18 ``aux`` the signing parties
read. A party may be old only (it deals, checks the confirms and ends
with ``result = None``), new only, or both. Host python ints throughout.
"""
from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..core import hostmath as hm
from ..core.paillier import PaillierPublicKey, PreParams
from . import commitments as cm
from .base import KeygenShare, PartyBase, ProtocolError, RoundMsg, party_xs
from .ecdsa.keygen import MIN_PAILLIER_BITS
from .ecdsa.zk import DLNProof, PaillierProof

R1 = "reshare/1/commit"
R2_DECOMMIT = "reshare/2/decommit"
R2_SHARE = "reshare/2/share"
R3_CONFIRM = "reshare/3/confirm"


@dataclass(frozen=True)
class CurveOps:
    name: str
    order: int
    mul: Callable  # (k, point) -> point
    add: Callable
    compress: Callable
    decompress: Callable
    generator: object
    identity: object


ED_OPS = CurveOps(name="ed25519", order=hm.ED_L, mul=hm.ed_mul, add=hm.ed_add,
                  compress=hm.ed_compress, decompress=hm.ed_decompress,
                  generator=hm.ED_B, identity=hm.ED_IDENT)

SECP_OPS = CurveOps(name="secp256k1", order=hm.SECP_N, mul=hm.secp_mul, add=hm.secp_add,
                    compress=hm.secp_compress, decompress=hm.secp_decompress,
                    generator=hm.SECP_G, identity=hm.SECP_INF)


def curve_ops(key_type: str) -> CurveOps:
    return {"ed25519": ED_OPS, "secp256k1": SECP_OPS}[key_type]


def _confirm_digest(public_key: bytes, new_agg: Sequence[bytes]) -> str:
    return hashlib.sha256(b"reshare-confirm" + public_key + b"".join(new_agg)).hexdigest()


class ResharingParty(PartyBase):
    """One participant of a resharing session.

    ``old_quorum``: the ≥ t_old+1 old holders that re-deal (all must take
    part). ``new_committee``: the receivers. ``old_share`` is required iff
    this party is in the old quorum; ``preparams`` iff the curve is
    secp256k1 and this party is in the new committee. A new-only member
    takes the old public key and aggregated commitments from the wallet's
    metadata.
    """

    _SNAP_EXTRA = (
        "_sent_r2", "_sent_r3", "_w_i", "_coeffs", "_shares_out",
        "_points", "_commitment", "_blind", "_x_new", "_new_agg",
        "new_agg", "pre",
    )

    def __init__(self, session_id: str, self_id: str, key_type: str,
                 old_quorum: Sequence[str], new_committee: Sequence[str],
                 new_threshold: int, old_share: Optional[KeygenShare] = None,
                 old_public_key: Optional[bytes] = None,
                 old_vss_commitments: Optional[Sequence[bytes]] = None,
                 preparams: Optional[PreParams] = None, rng=None,
                 min_paillier_bits: int = MIN_PAILLIER_BITS, old_epoch: int = 0):
        all_ids = sorted(set(old_quorum) | set(new_committee))
        super().__init__(session_id, self_id, all_ids, rng or secrets)
        self.old_epoch = old_epoch
        self.new_epoch = old_epoch + 1
        # set at finalize for EVERY role (an old-only member recomputes it
        # from the R1/R2 broadcasts), so each can follow the new topology
        self.new_agg: Optional[List[bytes]] = None
        self.ops = curve_ops(key_type)
        self.key_type = key_type
        self.old_quorum = sorted(old_quorum)
        self.new_committee = sorted(new_committee)
        self.is_old = self_id in set(old_quorum)
        self.is_new = self_id in set(new_committee)
        self.min_paillier_bits = min_paillier_bits
        if not 0 < new_threshold < len(new_committee):
            raise ValueError("need 0 < t_new < |new committee|")
        self.new_threshold = new_threshold
        self.pre = preparams
        if self.is_old:
            if old_share is None:
                raise ValueError("old-quorum member needs its share")
            if old_share.key_type != key_type:
                raise ValueError("share key-type mismatch")
            self.old_share = old_share
            old_public_key = old_share.public_key
            old_vss_commitments = old_share.vss_commitments
        if old_public_key is None or old_vss_commitments is None:
            raise ValueError(
                "new-only members need old_public_key + old_vss_commitments "
                "(from keyinfo metadata)"
            )
        self.old_public_key = old_public_key
        self.old_agg = [self.ops.decompress(c) for c in old_vss_commitments]
        if key_type == "secp256k1" and self.is_new and preparams is None:
            raise ValueError("secp256k1 new-committee member needs preparams")

        # x-coordinate universes: a new-only member learns the old one from
        # the R1 payloads (cross-checked in _redeal_points)
        if self.is_old:
            self.old_xs = party_xs(self.old_share.participants)
            for pid in self.old_quorum:
                if pid not in self.old_xs:
                    raise ProtocolError("old member outside keygen universe", pid)
        else:
            self.old_xs = None
        self.new_xs = party_xs(self.new_committee)
        self._sent_r2 = False
        self._sent_r3 = False

    def start(self) -> List[RoundMsg]:
        if not self.is_old:
            return []
        ops = self.ops
        q = ops.order
        quorum_xs = [self.old_xs[p] for p in self.old_quorum]
        lam = hm.lagrange_coeff(quorum_xs, self.old_xs[self.self_id], q)
        self._w_i = lam * self.old_share.share % q
        self._coeffs, self._shares_out = hm.shamir_share(
            self._w_i, self.new_threshold, [self.new_xs[p] for p in self.new_committee], q,
            rng=self.rng,
        )
        self._points = [ops.compress(ops.mul(c, ops.generator)) for c in self._coeffs]
        self._commitment, self._blind = cm.commit(cm.encode_points(self._points), rng=self.rng)
        return [self.broadcast(R1, {
            "commitment": self._commitment.hex(),
            "old_participants": list(self.old_share.participants),
        })]

    def receive(self, msg: RoundMsg) -> List[RoundMsg]:
        if self.done:
            return []
        expect_old = [p for p in self.old_quorum if p != self.self_id]
        expect_new = [p for p in self.new_committee if p != self.self_id]
        self._store(msg)
        out: List[RoundMsg] = []

        if self.is_old and not self._sent_r2 and self._round_full(R1, expect_old):
            self._sent_r2 = True
            out.append(self.broadcast(R2_DECOMMIT, {
                "points": [p.hex() for p in self._points],
                "blind": self._blind.hex(),
            }))
            for pid in self.new_committee:
                if pid != self.self_id:
                    out.append(self.unicast(pid, R2_SHARE, {
                        "share": str(self._shares_out[self.new_xs[pid]])}))

        if (self.is_new and not self._sent_r3 and self._round_full(R1, expect_old)
                and self._round_full(R2_DECOMMIT, expect_old)
                and self._round_full(R2_SHARE, expect_old)):
            self._sent_r3 = True
            out.append(self._build_confirm())

        if self._round_full(R3_CONFIRM, expect_new) and (not self.is_new or self._sent_r3):
            # an old-only member also needs every R1/R2 broadcast to
            # recompute the new commitments in _finalize
            if self.is_new or (self._round_full(R1, expect_old)
                               and self._round_full(R2_DECOMMIT, expect_old)):
                self._finalize()
        return out

    # -- verification of the redeal and the confirm -------------------------

    def _redeal_points(self) -> Dict[str, list]:
        """Check the decommitments and the C_i0 binding → each old
        member's Feldman points. Needs R1 and R2 full."""
        ops = self.ops
        commits = self._round_payloads(R1)
        decommits = self._round_payloads(R2_DECOMMIT)

        # one old keygen universe, claimed alike by every old member
        old_parts = None
        for pid in self.old_quorum:
            if pid == self.self_id:
                parts = list(self.old_share.participants)
            else:
                parts = list(commits[pid]["old_participants"])
            if old_parts is None:
                old_parts = parts
            elif old_parts != parts:
                raise ProtocolError("inconsistent old-universe claims", pid)
        old_xs = party_xs(old_parts)
        for pid in self.old_quorum:
            if pid not in old_xs:
                raise ProtocolError("old member outside claimed universe", pid)
        quorum_xs = [old_xs[p] for p in self.old_quorum]

        all_points: Dict[str, list] = {}
        for pid in self.old_quorum:
            if pid == self.self_id:
                pts = [ops.decompress(p) for p in self._points]
            else:
                pts_hex = decommits[pid]["points"]
                if len(pts_hex) != self.new_threshold + 1:
                    raise ProtocolError("wrong redeal commitment count", pid)
                pts_bytes = [bytes.fromhex(p) for p in pts_hex]
                if not cm.verify(bytes.fromhex(commits[pid]["commitment"]),
                                 bytes.fromhex(decommits[pid]["blind"]),
                                 cm.encode_points(pts_bytes)):
                    raise ProtocolError("redeal decommitment mismatch", pid)
                try:
                    pts = [ops.decompress(p) for p in pts_bytes]
                except ValueError as e:
                    raise ProtocolError(f"bad redeal point: {e}", pid)
            # C_i0 must equal λ_i·X_i: the public binding to the old key
            lam = hm.lagrange_coeff(quorum_xs, old_xs[pid], ops.order)
            expect = ops.mul(lam, _eval_commitments_generic(ops, self.old_agg, old_xs[pid]))
            if ops.compress(pts[0]) != ops.compress(expect):
                raise ProtocolError("redeal does not match old key share", pid)
            all_points[pid] = pts
        return all_points

    def _aggregate(self, all_points: Dict[str, list]) -> List[bytes]:
        agg = []
        for k in range(self.new_threshold + 1):
            acc = self.ops.identity
            for pid in self.old_quorum:
                acc = self.ops.add(acc, all_points[pid][k])
            agg.append(self.ops.compress(acc))
        return agg

    def _old_public_key(self) -> bytes:
        return self.ops.compress(self.ops.decompress(self.old_public_key))

    def _build_confirm(self) -> RoundMsg:
        ops = self.ops
        all_points = self._redeal_points()
        shares = self._round_payloads(R2_SHARE)
        my_x = self.new_xs[self.self_id]
        x_new = 0
        for pid in self.old_quorum:
            if pid == self.self_id:
                s = self._shares_out[my_x]
            else:
                s = int(shares[pid]["share"])
                if not 0 <= s < ops.order:
                    raise ProtocolError("sub-share out of range", pid)
                expect = _eval_commitments_generic(ops, all_points[pid], my_x)
                if ops.compress(ops.mul(s, ops.generator)) != ops.compress(expect):
                    raise ProtocolError("sub-share VSS verification failed", pid)
            x_new = (x_new + s) % ops.order
        new_agg = self._aggregate(all_points)
        if new_agg[0] != self._old_public_key():
            raise ProtocolError("resharing changed the public key")
        self._x_new = x_new
        self._new_agg = new_agg
        payload = {"digest": _confirm_digest(new_agg[0], new_agg)}
        if self.key_type == "secp256k1":
            payload.update(self._paillier_payload())
        return self.broadcast(R3_CONFIRM, payload)

    # -- secp256k1: the new committee's Paillier material -------------------

    def _paillier_payload(self) -> dict:
        pre = self.pre
        pq = (pre.P - 1) // 2 * ((pre.Q - 1) // 2)
        bind = f"{self.session_id}:{self.self_id}".encode()
        return {
            "paillier_n": str(pre.paillier.N),
            "ntilde": str(pre.NTilde),
            "h1": str(pre.h1),
            "h2": str(pre.h2),
            "dln1": DLNProof.prove(pre.h1, pre.h2, pre.alpha, pq, pre.NTilde, self.rng,
                                   bind=bind).to_json(),
            "dln2": DLNProof.prove(pre.h2, pre.h1, pre.beta, pq, pre.NTilde, self.rng,
                                   bind=bind).to_json(),
            "paillier_proof": PaillierProof.prove(pre.paillier, bind=bind).to_json(),
        }

    def _verify_paillier_payload(self, pid: str, p: dict) -> dict:
        N = int(p["paillier_n"])
        ntilde, h1, h2 = int(p["ntilde"]), int(p["h1"]), int(p["h2"])
        if N.bit_length() < self.min_paillier_bits:
            raise ProtocolError("Paillier modulus too small", pid)
        if ntilde.bit_length() < self.min_paillier_bits:
            raise ProtocolError("NTilde too small", pid)
        if h1 in (0, 1) or h2 in (0, 1) or h1 == h2:
            raise ProtocolError("degenerate ring-Pedersen bases", pid)
        bind = f"{self.session_id}:{pid}".encode()
        if not DLNProof.from_json(p["dln1"]).verify(h1, h2, ntilde, bind=bind):
            raise ProtocolError("DLN proof failed", pid)
        if not DLNProof.from_json(p["dln2"]).verify(h2, h1, ntilde, bind=bind):
            raise ProtocolError("DLN proof failed", pid)
        proof = PaillierProof.from_json(p["paillier_proof"])
        if N.bit_length() >= 2046:
            if not proof.verify(PaillierPublicKey(N), bind=bind):
                raise ProtocolError("Paillier validity proof failed", pid)
        return {"N": N, "ntilde": ntilde, "h1": h1, "h2": h2}

    # -- finalize ------------------------------------------------------------

    def _finalize(self) -> None:
        confirms = self._round_payloads(R3_CONFIRM)
        digests = set()
        peer_material: Dict[str, dict] = {}
        for pid in self.new_committee:
            if pid == self.self_id:
                continue
            digests.add(confirms[pid]["digest"])
            if self.key_type == "secp256k1" and self.is_new:
                peer_material[pid] = self._verify_paillier_payload(pid, confirms[pid])
        if len(digests) > 1:
            raise ProtocolError("new committee disagrees on reshared key")

        if not self.is_new:
            # old only: recompute the new commitments from the R1/R2
            # broadcasts and check them against the committee's digest, so
            # this member's keyinfo follows the rotation without a share
            new_agg = self._aggregate(self._redeal_points())
            if digests and digests != {_confirm_digest(self._old_public_key(), new_agg)}:
                raise ProtocolError("confirm digest mismatch (old-only view)")
            self.new_agg = new_agg
            self.result = None
            self.done = True
            return

        if digests and digests != {_confirm_digest(self._old_public_key(), self._new_agg)}:
            raise ProtocolError("confirm digest mismatch")

        aux = {"is_reshared": True}
        if self.key_type == "secp256k1":
            aux.update({
                "paillier_sk": self.pre.paillier.to_json(),
                "preparams": {
                    "ntilde": str(self.pre.NTilde),
                    "h1": str(self.pre.h1),
                    "h2": str(self.pre.h2),
                },
                "peer_paillier": {pid: str(m["N"]) for pid, m in peer_material.items()},
                "peer_ring_pedersen": {
                    pid: {"ntilde": str(m["ntilde"]), "h1": str(m["h1"]), "h2": str(m["h2"])}
                    for pid, m in peer_material.items()
                },
            })
        self.new_agg = list(self._new_agg)
        self.result = KeygenShare(
            key_type=self.key_type,
            share=self._x_new,
            self_x=self.new_xs[self.self_id],
            public_key=bytes(self.old_public_key),
            vss_commitments=self._new_agg,
            participants=list(self.new_committee),
            threshold=self.new_threshold,
            epoch=self.new_epoch,
            aux=aux,
        )
        self.done = True


def _eval_commitments_generic(ops: CurveOps, points, x: int):
    """Σ_k x^k · C_k (Horner over the group)."""
    acc = ops.identity
    for pt in reversed(points):
        acc = ops.add(ops.mul(x, acc), pt)
    return acc
