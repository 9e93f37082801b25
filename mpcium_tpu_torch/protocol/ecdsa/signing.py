"""GG18 threshold ECDSA signing, one digest per session (secp256k1; the
port's copy of ``mpcium_tpu/protocol/ecdsa/signing.py``).

Nine rounds, ten message types:

  R1a (unicast)   MtA init: c_i = Enc_i(k_i) + range proof per verifier
  R1b (broadcast) hash commitment to Γ_i = γ_i·G
  R2  (unicast)   MtA responses: k_j·γ_i and k_j·w_i (with check)
  R3  (broadcast) δ_i = k_i·γ_i + Σ(α+β)
  R4  (broadcast) Γ decommit + Schnorr PoK of γ_i → R = δ⁻¹·ΣΓ, r = R_x
  R5  (broadcast) commit to V_i = s_i·R + l_i·G, A_i = ρ_i·G     (5A)
  R6  (broadcast) decommit + PoK of (s_i, l_i)                    (5B)
  R7  (broadcast) commit to U_i = ρ_i·V, T_i = l_i·A              (5C)
  R8  (broadcast) decommit U_i, T_i; check ΣT == ΣU               (5D)
  R9  (broadcast) s_i; s = Σs_i, low-s normalize, verify          (5E)

The phase-5 commit/reveal means no party learns whether the signature
verifies before every party is committed to its s_i. The additive key
share is w_i = λ_i·x_i (λ over the quorum, x-coordinates from the keygen
universe); W_i = λ_i·X_i comes from the aggregated VSS commitments, and
the MtAwc check pins it. Host python ints throughout: the batched party
(``batch_signing.py``) runs the same protocol on the card.
"""
from __future__ import annotations

import secrets
from typing import Dict, List, Sequence

from ...core import hostmath as hm
from ...core.paillier import PaillierPrivateKey, PaillierPublicKey
from .. import commitments as cm
from ..base import KeygenShare, PartyBase, ProtocolError, RoundMsg, party_xs
from . import mta
from .keygen import _eval_commitments
from .zk import PedersenPoK, Q, SchnorrProof

R1_MTA = "ecdsa/sign/1/mta"
R1_COMMIT = "ecdsa/sign/1/commit"
R2 = "ecdsa/sign/2"
R3 = "ecdsa/sign/3"
R4 = "ecdsa/sign/4"
R5 = "ecdsa/sign/5"
R6 = "ecdsa/sign/6"
R7 = "ecdsa/sign/7"
R8 = "ecdsa/sign/8"
R9 = "ecdsa/sign/9"


def _neg(P: hm.SecpPoint) -> hm.SecpPoint:
    return P if P.is_infinity else hm.SecpPoint(P.x, (-P.y) % hm.SECP_P)


class ECDSASigningParty(PartyBase):
    """One signer among the quorum (≥ t+1 keygen participants)."""

    # k_i, γ_i and every phase-5 secret are committed to the peers: a
    # resumed signer must replay the identical values
    _SNAP_EXTRA = (
        "_stage", "k_i", "gamma_i", "Gamma_i", "_gamma_commit",
        "_gamma_blind", "_mta_inits", "_beta", "_nu", "_delta_i",
        "_sigma_i", "_R", "_r", "_s_i", "_l_i", "_rho_i", "_V_i", "_A_i",
        "_va_commit", "_va_blind", "_peer_VA", "_U_i", "_T_i",
        "_ut_commit", "_ut_blind",
    )

    def __init__(self, session_id: str, self_id: str, party_ids: Sequence[str],
                 share: KeygenShare, digest: int, rng=None):
        super().__init__(session_id, self_id, party_ids, rng or secrets)
        if len(party_ids) < share.threshold + 1:
            raise ProtocolError("not enough participants for threshold")
        if share.key_type != "secp256k1":
            raise ValueError("wrong key type for ECDSA signing")
        self.share = share
        self.digest = digest % Q
        keygen_xs = party_xs(share.participants)
        for pid in party_ids:
            if pid not in keygen_xs:
                raise ProtocolError("signer not in keygen participant set", pid)
        self.xs = {pid: keygen_xs[pid] for pid in self.party_ids}
        self.self_x = self.xs[self_id]
        assert self.self_x == share.self_x

        # additive share w_i = λ_i·x_i and the public W_j of every signer
        quorum_xs = [self.xs[p] for p in self.party_ids]
        self.lam = {pid: hm.lagrange_coeff(quorum_xs, self.xs[pid], Q)
                    for pid in self.party_ids}
        self.w_i = self.lam[self_id] * share.share % Q
        agg_points = [hm.secp_decompress(c) for c in share.vss_commitments]
        self.W = {pid: hm.secp_mul(self.lam[pid], _eval_commitments(agg_points, self.xs[pid]))
                  for pid in self.party_ids}
        self.pub = hm.secp_decompress(share.public_key)

        aux = share.aux
        self.paillier_sk = PaillierPrivateKey.from_json(aux["paillier_sk"])
        self.own_rp = {k: int(v) for k, v in aux["preparams"].items()}
        self.peer_pk = {pid: PaillierPublicKey(int(n)) for pid, n in aux["peer_paillier"].items()}
        self.peer_rp = {pid: {k: int(v) for k, v in rp.items()}
                        for pid, rp in aux["peer_ring_pedersen"].items()}
        for pid in self.others():
            if pid not in self.peer_pk or pid not in self.peer_rp:
                raise ProtocolError("missing peer Paillier material", pid)

        self._stage = 0  # last completed send stage (1..9)

    def _bind(self, sender: str) -> bytes:
        """Session+sender binding of the signing commitments and PoKs: a
        signer cannot replay another party's Γ commitment or decommit+PoK
        as its own, so the culprit of an abort is named right."""
        return f"{self.session_id}:{sender}".encode()

    # -- round 1 ------------------------------------------------------------

    def start(self) -> List[RoundMsg]:
        self.k_i = self.rng.randbelow(Q - 1) + 1
        self.gamma_i = self.rng.randbelow(Q - 1) + 1
        self.Gamma_i = hm.secp_mul(self.gamma_i, hm.SECP_G)
        data = self._bind(self.self_id) + hm.secp_compress(self.Gamma_i)
        self._gamma_commit, self._gamma_blind = cm.commit(data, rng=self.rng)

        out = [self.broadcast(R1_COMMIT, {"commitment": self._gamma_commit.hex()})]
        # one Enc(k_i) per verifier: the range proof is bound to the
        # verifier's ring-Pedersen parameters
        self._mta_inits: Dict[str, mta.MtaInit] = {}
        pk_own = self.paillier_sk.public
        for pid in self.others():
            rp = self.peer_rp[pid]
            init, _r = mta.mta_init(pk_own, rp["ntilde"], rp["h1"], rp["h2"], self.k_i,
                                    rng=self.rng)
            self._mta_inits[pid] = init
            out.append(self.unicast(pid, R1_MTA, {"init": init.to_json()}))
        self._stage = 1
        return out

    # -- dispatch -----------------------------------------------------------

    def receive(self, msg: RoundMsg) -> List[RoundMsg]:
        if self.done:
            return []
        self._store(msg)
        out: List[RoundMsg] = []
        others = self.others()

        if (self._stage == 1 and self._round_full(R1_MTA, others)
                and self._round_full(R1_COMMIT, others)):
            out.extend(self._round2())
            self._stage = 2
        for stage, rnd, step in ((2, R2, self._round3), (3, R3, self._round4),
                                 (4, R4, self._round5), (5, R5, self._round6),
                                 (6, R6, self._round7), (7, R7, self._round8),
                                 (8, R8, self._round9)):
            if self._stage == stage and self._round_full(rnd, others):
                out.append(step())
                self._stage = stage + 1
        if self._stage == 9 and self._round_full(R9, others):
            self._finalize()
        return out

    # -- round 2: MtA responses --------------------------------------------

    def _round2(self) -> List[RoundMsg]:
        inits = self._round_payloads(R1_MTA)
        out: List[RoundMsg] = []
        self._beta: Dict[str, int] = {}  # from k_j·γ_i
        self._nu: Dict[str, int] = {}  # from k_j·w_i
        own = self.own_rp
        for pid in self.others():
            init = mta.MtaInit.from_json(inits[pid]["init"])
            pk_j = self.peer_pk[pid]
            rp_j = self.peer_rp[pid]
            try:
                resp_g, beta = mta.mta_respond(
                    pk_j, rp_j["ntilde"], rp_j["h1"], rp_j["h2"],
                    own["ntilde"], own["h1"], own["h2"],
                    init, self.gamma_i, with_check=False, rng=self.rng)
                resp_w, nu = mta.mta_respond(
                    pk_j, rp_j["ntilde"], rp_j["h1"], rp_j["h2"],
                    own["ntilde"], own["h1"], own["h2"],
                    init, self.w_i, with_check=True, rng=self.rng,
                    init_verified=True)  # the γ response above verified it
            except ValueError as e:
                raise ProtocolError(f"MtA: {e}", pid)
            self._beta[pid] = beta
            self._nu[pid] = nu
            out.append(self.unicast(pid, R2, {"gamma": resp_g.to_json(),
                                              "w": resp_w.to_json()}))
        return out

    # -- round 3: δ_i -------------------------------------------------------

    def _round3(self) -> RoundMsg:
        resps = self._round_payloads(R2)
        own = self.own_rp
        delta_i = self.k_i * self.gamma_i % Q
        sigma_i = self.k_i * self.w_i % Q
        for pid in self.others():
            init = self._mta_inits[pid]
            resp_g = mta.MtaResp.from_json(resps[pid]["gamma"])
            resp_w = mta.MtaResp.from_json(resps[pid]["w"])
            try:
                alpha = mta.mta_finalize(self.paillier_sk, own["ntilde"], own["h1"],
                                         own["h2"], init, resp_g)
                mu = mta.mta_finalize(self.paillier_sk, own["ntilde"], own["h1"], own["h2"],
                                      init, resp_w, X=self.W[pid])
            except ValueError as e:
                raise ProtocolError(f"MtA finalize: {e}", pid)
            delta_i = (delta_i + alpha + self._beta[pid]) % Q  # mpcflow: declassified — δᵢ is the GG18 R3 public reveal
            sigma_i = (sigma_i + mu + self._nu[pid]) % Q
        self._delta_i = delta_i
        self._sigma_i = sigma_i
        return self.broadcast(R3, {"delta": str(delta_i)})

    # -- round 4: Γ decommit → R -------------------------------------------

    def _round4(self) -> RoundMsg:
        pok = SchnorrProof.prove(self.gamma_i, self.Gamma_i, rng=self.rng,
                                 bind=self._bind(self.self_id))
        return self.broadcast(R4, {
            "Gamma": hm.secp_compress(self.Gamma_i).hex(),
            "blind": self._gamma_blind.hex(),
            "pok": pok.to_json(),
        })

    # -- round 5 (5A): commit V_i, A_i -------------------------------------

    def _round5(self) -> RoundMsg:
        commits = self._round_payloads(R1_COMMIT)
        deltas = self._round_payloads(R3)
        decommits = self._round_payloads(R4)
        delta = self._delta_i
        for pid in self.others():
            d = int(deltas[pid]["delta"])
            if not 0 <= d < Q:
                raise ProtocolError("delta out of range", pid)
            delta = (delta + d) % Q
        if delta == 0:
            raise ProtocolError("degenerate delta (k·γ = 0)")
        Gamma = self.Gamma_i
        for pid in self.others():
            gb = bytes.fromhex(decommits[pid]["Gamma"])
            if not cm.verify(bytes.fromhex(commits[pid]["commitment"]),
                             bytes.fromhex(decommits[pid]["blind"]), self._bind(pid) + gb):
                raise ProtocolError("Γ decommitment mismatch", pid)
            try:
                Gamma_j = hm.secp_decompress(gb)
            except ValueError as e:
                raise ProtocolError(f"bad Γ point: {e}", pid)
            if not SchnorrProof.from_json(decommits[pid]["pok"]).verify(
                    Gamma_j, bind=self._bind(pid)):
                raise ProtocolError("Γ PoK failed", pid)
            Gamma = hm.secp_add(Gamma, Gamma_j)
        R = hm.secp_mul(pow(delta, -1, Q), Gamma)
        if R.is_infinity:
            raise ProtocolError("degenerate R")
        self._R = R
        self._r = R.x % Q
        if self._r == 0:
            raise ProtocolError("degenerate r = 0")
        self._s_i = (self.digest * self.k_i + self._r * self._sigma_i) % Q
        self._l_i = self.rng.randbelow(Q - 1) + 1
        self._rho_i = self.rng.randbelow(Q - 1) + 1
        self._V_i = hm.secp_add(hm.secp_mul(self._s_i, R), hm.secp_mul(self._l_i, hm.SECP_G))
        self._A_i = hm.secp_mul(self._rho_i, hm.SECP_G)
        data = (self._bind(self.self_id) + hm.secp_compress(self._V_i)
                + hm.secp_compress(self._A_i))
        self._va_commit, self._va_blind = cm.commit(data, rng=self.rng)
        return self.broadcast(R5, {"commitment": self._va_commit.hex()})

    # -- round 6 (5B): decommit V_i, A_i + PoK ------------------------------

    def _round6(self) -> RoundMsg:
        pok = PedersenPoK.prove(self._s_i, self._l_i, self._R, self._V_i, rng=self.rng,
                                bind=self._bind(self.self_id))
        return self.broadcast(R6, {
            "V": hm.secp_compress(self._V_i).hex(),
            "A": hm.secp_compress(self._A_i).hex(),
            "blind": self._va_blind.hex(),
            "pok": pok.to_json(),
        })

    # -- round 7 (5C): commit U_i, T_i --------------------------------------

    def _round7(self) -> RoundMsg:
        commits = self._round_payloads(R5)
        decommits = self._round_payloads(R6)
        V_sum = self._V_i
        A_sum = self._A_i
        self._peer_VA: Dict[str, tuple] = {}
        for pid in self.others():
            Vb = bytes.fromhex(decommits[pid]["V"])
            Ab = bytes.fromhex(decommits[pid]["A"])
            if not cm.verify(bytes.fromhex(commits[pid]["commitment"]),
                             bytes.fromhex(decommits[pid]["blind"]),
                             self._bind(pid) + Vb + Ab):
                raise ProtocolError("V/A decommitment mismatch", pid)
            try:
                V_j = hm.secp_decompress(Vb)
                A_j = hm.secp_decompress(Ab)
            except ValueError as e:
                raise ProtocolError(f"bad V/A point: {e}", pid)
            if not PedersenPoK.from_json(decommits[pid]["pok"]).verify(
                    self._R, V_j, bind=self._bind(pid)):
                raise ProtocolError("V_i PoK failed", pid)
            self._peer_VA[pid] = (V_j, A_j)
            V_sum = hm.secp_add(V_sum, V_j)
            A_sum = hm.secp_add(A_sum, A_j)
        # V = -m·G - r·y + ΣV_i; honest ⇒ V = (Σl_i)·G
        V = hm.secp_add(V_sum, hm.secp_add(_neg(hm.secp_mul(self.digest, hm.SECP_G)),
                                           _neg(hm.secp_mul(self._r, self.pub))))
        self._U_i = hm.secp_mul(self._rho_i, V)
        self._T_i = hm.secp_mul(self._l_i, A_sum)
        data = (self._bind(self.self_id) + hm.secp_compress(self._U_i)
                + hm.secp_compress(self._T_i))
        self._ut_commit, self._ut_blind = cm.commit(data, rng=self.rng)
        return self.broadcast(R7, {"commitment": self._ut_commit.hex()})

    # -- round 8 (5D): decommit U_i, T_i ------------------------------------

    def _round8(self) -> RoundMsg:
        return self.broadcast(R8, {
            "U": hm.secp_compress(self._U_i).hex(),
            "T": hm.secp_compress(self._T_i).hex(),
            "blind": self._ut_blind.hex(),
        })

    # -- round 9 (5E): reveal s_i -------------------------------------------

    def _round9(self) -> RoundMsg:
        commits = self._round_payloads(R7)
        decommits = self._round_payloads(R8)
        U_sum = self._U_i
        T_sum = self._T_i
        for pid in self.others():
            Ub = bytes.fromhex(decommits[pid]["U"])
            Tb = bytes.fromhex(decommits[pid]["T"])
            if not cm.verify(bytes.fromhex(commits[pid]["commitment"]),
                             bytes.fromhex(decommits[pid]["blind"]),
                             self._bind(pid) + Ub + Tb):
                raise ProtocolError("U/T decommitment mismatch", pid)
            try:
                U_sum = hm.secp_add(U_sum, hm.secp_decompress(Ub))
                T_sum = hm.secp_add(T_sum, hm.secp_decompress(Tb))
            except ValueError as e:
                raise ProtocolError(f"bad U/T point: {e}", pid)
        # honest: ΣU_i = ρ·(Σl)G and ΣT_i = l·(Σρ)G, equal iff s is consistent
        if U_sum != T_sum:
            raise ProtocolError(
                "phase-5 consistency check failed (ΣU ≠ ΣT): some party's "
                "s_i is inconsistent; aborting before any s_i is revealed"
            )
        return self.broadcast(R9, {"s": str(self._s_i)})

    # -- finalize ------------------------------------------------------------

    def _finalize(self) -> None:
        partials = self._round_payloads(R9)
        s = self._s_i
        for pid in self.others():
            v = int(partials[pid]["s"])
            if not 0 <= v < Q:
                raise ProtocolError("partial s out of range", pid)
            s = (s + v) % Q
        if s == 0:
            raise ProtocolError("degenerate s = 0")
        r = self._r
        rec = (self._R.y & 1) | (2 if self._R.x >= Q else 0)
        if s > Q // 2:  # low-s normalization
            s = Q - s
            rec ^= 1
        if not hm.ecdsa_verify(self.pub, self.digest, r, s):
            raise ProtocolError("aggregate ECDSA signature failed verification")
        self.result = {"r": r, "s": s, "recovery": rec}
        self.done = True
