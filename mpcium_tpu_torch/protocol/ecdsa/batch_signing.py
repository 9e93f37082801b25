"""Distributed batched GG18 threshold-ECDSA signing: one protocol instance
signs B wallets' digests concurrently.

The port of ``mpcium_tpu/protocol/ecdsa/batch_signing.py``: the
distributed counterpart of the in-process
:class:`engine.gg18_batch.GG18BatchCoSigners`. Each quorum member
exchanges fixed-shape byte blocks (B-row limb serializations) and
computes every round with the engine's blocks on ``device``; every
Paillier encryption, range proof and CRT decryption runs the CUDA
mulmod kernel on a GPU.

Wire schedule (9 network rounds, the GG18 round structure):

  R1  broadcast  Γ-commitment block + Enc_i(k_i) ciphertext block
      unicast→j  MtA range proof of Enc_i(k_i) in j's ring
  R2  unicast→j  MtA responses (γ and w legs): c_b + range proofs
  R3  broadcast  δ_i block (after verifying responses + CRT decrypting)
  R4  broadcast  Γ_i decommit + Schnorr PoK of γ_i
  R5  broadcast  phase-5A (V_i, A_i) commitment block
  R6  broadcast  5B decommit + Pedersen PoK of (s_i, l_i)
  R7  broadcast  5C (U_i, T_i) commitment block
  R8  broadcast  5D decommit
  R9  broadcast  partial-signature block s_i
  finalize       combine, low-s normalize, batched ECDSA verify → ok mask

Per-lane semantics: a failed proof, commitment or point decoding clears
only its wallet's lane of the result's ok mask; structural violations
(bad block sizes, equivocation) abort the batch with the culprit named.
The nine wire rounds run on the full batch, so the transcript does not
depend on the cohort count; only the finalize is cohorted. Round names,
payload fields and hash domains are the JAX package's byte for byte.

All wallets in a batch share (participants, threshold, epoch) and the
quorum's Paillier/ring-Pedersen material (:func:`quorum_material_digest`):
the party builds one modulus context per member.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import wire
from ...core import bignum as bn
from ...core import hostmath as hm
from ...core import secp256k1 as sp
from ...core.bignum import P256
from ...core.paillier import PaillierPrivateKey, PreParams
from ...device import resolve
from ...engine import gg18_batch as gb
from ...engine import pipeline as pl
from ...ops.paillier_mxu import RAND_BITS
from ...utils import tracing
from ..base import BatchBlockMixin, KeygenShare, PartyBase, ProtocolError, RoundMsg, party_xs

Q = hm.SECP_N

R1B = "gg18/b/1/commit"
R1A = "gg18/b/1/rangeproof"
R2 = "gg18/b/2/respond"
R3 = "gg18/b/3/delta"
R4 = "gg18/b/4/decommit"
R5 = "gg18/b/5/va-commit"
R6 = "gg18/b/6/va-reveal"
R7 = "gg18/b/7/ut-commit"
R8 = "gg18/b/8/ut-reveal"
R9 = "gg18/b/9/partial"

# the ten proof fields of a Bob response leg: name → (transcript or
# proof, key, which profile)
_BOB_T = (("cb", "c_b", "n2"), ("z", "z", "nt"), ("zp", "z_p", "nt"), ("t", "t", "nt"),
          ("v", "v", "n2"), ("w", "w", "nt"))
_BOB_P = (("s", "s", "n"), ("s1", "s1", "s1"), ("s2", "s2", "s2"), ("t1", "t1", "t1"),
          ("t2", "t2", "s2"))


def quorum_material_digest(share: KeygenShare) -> str:
    """Digest of the committee's shared Paillier/ring-Pedersen material:
    equal across the quorum's nodes for wallets of one committee
    generation, the scheduler's batch-homogeneity key. "" without aux."""
    aux = share.aux
    if not aux or "paillier_sk" not in aux:
        return ""
    sk = aux["paillier_sk"]
    mat = {
        "paillier": dict(aux.get("peer_paillier", {})),
        "ring": {pid: dict(rp) for pid, rp in aux.get("peer_ring_pedersen", {}).items()},
    }
    owner = share_owner_key(share)
    mat["paillier"][owner] = str(int(sk["p"]) * int(sk["q"]))
    mat["ring"][owner] = dict(aux["preparams"])
    return hashlib.sha256(wire.canonical_json(mat)).hexdigest()


def share_owner_key(share: KeygenShare) -> str:
    """The owning party's ID, recovered from self_x within the sorted
    participant universe."""
    for pid, x in party_xs(share.participants).items():
        if x == share.self_x:
            return pid
    raise ProtocolError("share self_x not in participant universe")


def _nb(prof: bn.LimbProfile) -> int:
    return -(-prof.n_limbs * prof.bits // 8)


def _hex(t: torch.Tensor) -> str:
    return t.cpu().numpy().tobytes().hex()


def _ser(x: torch.Tensor, prof: bn.LimbProfile) -> str:
    return _hex(bn.limbs_to_bytes_le(x, prof, _nb(prof)))  # mpcflow: host-ok — wire serialization


class BatchedECDSASigningParty(BatchBlockMixin, PartyBase):
    """One signer's side of a B-session GG18 batch, computing on
    ``device`` (None: the GPU; raises when there is none — pass
    ``device="cpu"`` for the plain CPU path).

    ``shares``: this node's per-wallet key shares (manifest order,
    identical on every quorum member). ``digests``: the B 32-byte
    transaction digests. All shares come from one committee generation
    (same participants, threshold, epoch and aux material)."""

    def __init__(
        self,
        session_id: str,
        self_id: str,
        party_ids: Sequence[str],
        shares: Sequence[KeygenShare],
        digests: Sequence[bytes],
        dom: gb.Domains = gb.Domains(),
        rng=None,
        cohorts: Optional[int] = None,
        device=None,
    ):
        import secrets as _secrets

        self.device = resolve(device)
        super().__init__(session_id, self_id, party_ids, rng or _secrets)
        if len(shares) != len(digests) or not shares:
            raise ValueError("one share per digest required")
        self.B = len(shares)
        self.dom = dom
        first = shares[0]
        digest0 = quorum_material_digest(first)
        if not digest0:
            raise ProtocolError("shares carry no GG18 aux material")
        u_xs = party_xs(first.participants)
        for s in shares:
            if s.key_type != "secp256k1":
                raise ProtocolError("wrong key type for GG18 batch signing")
            if s.participants != first.participants:
                raise ProtocolError("mixed keygen universes in one batch")
            if s.threshold != first.threshold or s.epoch != first.epoch:
                raise ProtocolError("mixed threshold/epoch in one batch")
            if s.self_x != u_xs[self_id]:
                raise ProtocolError("share does not belong to this node")
            if len(s.vss_commitments) != s.threshold + 1:
                raise ProtocolError("missing VSS commitments on share")
            if quorum_material_digest(s) != digest0:
                raise ProtocolError("mixed Paillier material in one batch")
        if len(self.party_ids) < first.threshold + 1:
            raise ProtocolError("not enough participants for threshold")
        for pid in self.party_ids:
            if pid not in u_xs:
                raise ProtocolError("signer not in keygen universe", pid)

        dev = self.device
        aux = first.aux
        rp = {k: int(v) for k, v in aux["preparams"].items()}
        own_pre = PreParams(
            paillier=PaillierPrivateKey.from_json(aux["paillier_sk"]), NTilde=rp["ntilde"],
            h1=rp["h1"], h2=rp["h2"], alpha=0, beta=0, P=0, Q=0,
        )
        self.own = gb.PartyCtx(self_id, own_pre, rng=self.rng, device=dev)
        self.peers: Dict[str, gb.PartyCtx] = {}
        peer_pk = aux.get("peer_paillier", {})
        peer_rp = aux.get("peer_ring_pedersen", {})
        for pid in self.others():
            if pid not in peer_pk or pid not in peer_rp:
                raise ProtocolError("missing peer Paillier material", pid)
            prp = {k: int(v) for k, v in peer_rp[pid].items()}
            self.peers[pid] = gb.PartyCtx.public(
                pid, int(peer_pk[pid]), prp["ntilde"], prp["h1"], prp["h2"],
                rng=self.rng, device=dev,
            )
        # ordered-pair MtA contexts: out = self as Alice, in = self as Bob
        self.mta_out = {j: gb.MtaBatch(self.own, self.peers[j], dom) for j in self.others()}
        self.mta_in = {j: gb.MtaBatch(self.peers[j], self.own, dom) for j in self.others()}

        # quorum Shamir data, shared by the batch (one universe)
        quorum_xs = [u_xs[p] for p in self.party_ids]
        lam = {pid: hm.lagrange_coeff(quorum_xs, u_xs[pid], Q) for pid in self.party_ids}
        self._w = torch.as_tensor(
            bn.batch_to_limbs([lam[self_id] * s.share % Q for s in shares], P256), device=dev
        )
        self.ring = sp.scalar_ring(dev)

        with torch.inference_mode():
            # public per-wallet data: Y and every member's W_j
            pub = np.stack([np.frombuffer(s.public_key, dtype=np.uint8) for s in shares])
            self.Y, self._ok = sp.decompress(torch.as_tensor(pub, device=dev))
            C_comp = torch.as_tensor(np.stack([
                np.stack([np.frombuffer(c, dtype=np.uint8) for c in s.vss_commitments])
                for s in shares
            ]).transpose(1, 0, 2).copy(), device=dev)  # (t+1, B, 33)
            self.W_pts: Dict[str, sp.SecpPointJ] = {}
            for pid in self.party_ids:
                lam_bits = torch.as_tensor(sp.scalars_to_bits([lam[pid]])[0], device=dev)
                W, okW = gb._blk_W_from_vss(C_comp, u_xs[pid], lam_bits)
                self.W_pts[pid] = W
                self._ok = self._ok & okW
            digs = np.stack([np.frombuffer(bytes(d), dtype=np.uint8) for d in digests])
            if digs.shape[-1] != 32:
                raise ProtocolError("digests must be 32 bytes")
            self.m = self.ring.reduce(bn.bytes_to_limbs_le(
                torch.as_tensor(digs[:, ::-1].copy(), device=dev), P256, 22))
        # cohort geometry of the finalize (the nine wire rounds stay
        # full-batch: their draws are ordered per peer, and the wire must
        # not depend on the cohort count)
        self._plan = pl.CohortPlan.for_batch(self.B, cohorts)
        self._stage = 0

    # -- serialization helpers ----------------------------------------------

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _block(self, hexstr: str, nbytes: int, pid: str) -> torch.Tensor:
        return self._dev(self._parse_block(hexstr, nbytes, pid))

    def _parse_limbs(self, hexstr: str, prof: bn.LimbProfile, pid: str) -> torch.Tensor:
        return bn.bytes_to_limbs_le(self._block(hexstr, _nb(prof), pid), prof, prof.n_limbs)

    def _ser_scalar(self, x: torch.Tensor) -> str:
        return _hex(sp.pack_be_32(x))

    def _parse_scalar(self, hexstr: str, pid: str) -> torch.Tensor:
        be = self._parse_block(hexstr, 32, pid)
        return self.ring.reduce(
            bn.bytes_to_limbs_le(self._dev(be[:, ::-1].copy()), P256, 22))

    def _parse_point_block(self, hexstr: str, pid: str) -> Tuple[torch.Tensor, sp.SecpPointJ]:
        """A peer's compressed points; a bad encoding clears its lane."""
        comp = self._block(hexstr, 33, pid)
        pts, ok = sp.decompress(comp)
        self._ok = self._ok & ok
        return comp, pts

    def _wide_scalar(self) -> torch.Tensor:
        return gb._scalar_from_wide_bytes(self._dev(gb.rand_bits(self.B, 320, self.rng)))

    def _blind(self) -> torch.Tensor:
        return self._dev(gb.rand_bits(self.B, 256, self.rng))

    def _profs(self, ctx: gb.PartyCtx, mta: gb.MtaBatch) -> Dict[str, bn.LimbProfile]:
        """Wire profiles of a Bob leg whose Alice is ``ctx``."""
        return {"n": ctx.pmx.prof_n, "n2": ctx.pmx.prof_n2, "nt": ctx.ctx_nt.prof,
                "s1": mta.p_s1, "s2": mta.p_s2, "t1": mta.p_t1}

    # -- round 1 ------------------------------------------------------------

    @torch.inference_mode()
    def start(self) -> List[RoundMsg]:
        B = self.B
        with self._phase("gg18_r1_commit_encrypt_rangeproof"):
            self._k = self._wide_scalar()
            self._gamma = self._wide_scalar()
            self._gblind = self._blind()
            self._Gamma_own, self._Gamma_comp, commit = gb._blk_gamma(
                self._gamma, self._gblind, self._bind_row(self.self_id))
            u_bits = gb.rand_bit_tensor(B, RAND_BITS, self.rng, self.device)
            kp = gb._scalar_to_plain(self.own.pmx, self._k)
            self._c_k, _r = self.own.pmx.encrypt(kp, u_bits)
            out = [self.broadcast(R1B, {"gc": _hex(commit),  # mpcflow: host-ok — wire serialization of the hash commitment
                                        "ck": _ser(self._c_k, self.own.pmx.prof_n2)})]
            self._alice_beta: Dict[Tuple[str, str], torch.Tensor] = {}
            for j in self.others():
                mta = self.mta_out[j]
                Ra = mta.alice_randoms(B, self.rng)
                T = mta.alice_init(kp, Ra)
                e = mta.e_limbs(mta.alice_challenge(self._c_k, T))
                P = mta.alice_finish(e, kp, Ra, u_bits)
                nt_j = self.peers[j].ctx_nt.prof
                out.append(self.unicast(j, R1A, {
                    "z": _ser(T["z"], nt_j), "u": _ser(T["u"], self.own.pmx.prof_n2),
                    "w": _ser(T["w"], nt_j), "s": _ser(P["s"], self.own.pmx.prof_n),
                    "s1": _ser(P["s1"], mta.p_s1), "s2": _ser(P["s2"], mta.p_s2),
                }))
            tracing.span_sync(self.device)
        self._stage = 1
        return out

    # -- driver --------------------------------------------------------------

    _ROUNDS = ((1, (R1B, R1A), "_respond"), (2, (R2,), "_delta"),
               (3, (R3,), "_decommit_gamma"), (4, (R4,), "_phase5a"), (5, (R5,), "_phase5b"),
               (6, (R6,), "_phase5c"), (7, (R7,), "_phase5d"), (8, (R8,), "_partial"))

    def receive(self, msg: RoundMsg) -> List[RoundMsg]:
        if self.done:
            return []
        self._store(msg)
        others = self.others()
        out: List[RoundMsg] = []
        with torch.inference_mode():
            for stage, rounds, step in self._ROUNDS:
                if self._stage == stage and all(self._round_full(r, others) for r in rounds):
                    with self._phase(f"gg18{step}"):
                        sent = getattr(self, step)()
                        tracing.span_sync(self.device)
                    out.extend(sent if isinstance(sent, list) else [sent])
                    self._stage = stage + 1
            if self._stage == 9 and self._round_full(R9, others):
                self._finalize()
        return out

    # -- round 2: Bob side ---------------------------------------------------

    def _respond(self) -> List[RoundMsg]:
        B = self.B
        out = []
        own = self.own
        for j in self.others():
            mta = self.mta_in[j]  # alice = j, bob = self
            peer = self.peers[j]
            c_a = self._parse_limbs(self._round_payloads(R1B)[j]["ck"], peer.pmx.prof_n2, j)
            p = self._round_payloads(R1A)[j]
            T = {"z": self._parse_limbs(p["z"], own.ctx_nt.prof, j),
                 "u": self._parse_limbs(p["u"], peer.pmx.prof_n2, j),
                 "w": self._parse_limbs(p["w"], own.ctx_nt.prof, j)}
            P = {"s": self._parse_limbs(p["s"], peer.pmx.prof_n, j),
                 "s1": self._parse_limbs(p["s1"], mta.p_s1, j),
                 "s2": self._parse_limbs(p["s2"], mta.p_s2, j)}
            e = mta.e_limbs(mta.alice_challenge(c_a, T))
            self._ok = self._ok & mta.bob_check_alice(c_a, T, P, e, self.rng)
            prof = self._profs(peer, mta)
            payload = {}
            for name, secret in (("gamma", self._gamma), ("w", self._w)):
                Rb = mta.bob_randoms(B, self.rng)
                b_e = gb._scalar_to_prof(secret, mta.p_e)
                Tb = mta.bob_respond(c_a, b_e, Rb)
                extra = ()
                if name == "w":
                    _U_pt, U_comp = gb._base_mul_compressed(
                        gb._mod_q_from_limbs(Rb["alpha"], mta.p_alpha))
                    extra = (U_comp, sp.compress(self.W_pts[self.self_id]))
                    payload["w_U"] = _hex(U_comp)
                e_b = mta.e_limbs(mta.bob_challenge(c_a, Tb, extra))
                Pb = mta.bob_finish(e_b, b_e, Rb)
                self._alice_beta[(j, name)] = self.ring.negmod(
                    gb._mod_q_from_limbs(Rb["beta_prime"], mta.p_bp))
                for f, key, pr in _BOB_T:
                    payload[f"{name}_{f}"] = _ser(Tb[key], prof[pr])
                for f, key, pr in _BOB_P:
                    payload[f"{name}_{f}"] = _ser(Pb[key], prof[pr])
            out.append(self.unicast(j, R2, payload))
        return out

    # -- round 3: Alice verifies + decrypts, broadcasts δ_i ------------------

    def _delta(self) -> RoundMsg:
        ring = self.ring
        alpha: Dict[Tuple[str, str], torch.Tensor] = {}
        for j in self.others():
            mta = self.mta_out[j]
            p = self._round_payloads(R2)[j]
            prof = self._profs(self.own, mta)
            for name in ("gamma", "w"):
                Tb = {key: self._parse_limbs(p[f"{name}_{f}"], prof[pr], j)
                      for f, key, pr in _BOB_T}
                Pb = {key: self._parse_limbs(p[f"{name}_{f}"], prof[pr], j)
                      for f, key, pr in _BOB_P}
                extra = ()
                if name == "w":
                    U_comp, U_pt = self._parse_point_block(p["w_U"], j)
                    extra = (U_comp, sp.compress(self.W_pts[j]))
                e_b = mta.e_limbs(mta.bob_challenge(self._c_k, Tb, extra))
                self._ok = self._ok & mta.alice_check_bob(self._c_k, Tb, Pb, e_b, self.rng)
                if name == "w":
                    self._ok = self._ok & gb._withcheck_curve(
                        gb._mod_q_from_limbs(Pb["s1"], mta.p_s1),
                        gb._mod_q_from_limbs(e_b, mta.p_e), U_pt, self.W_pts[j])
                alpha[(j, name)] = mta.alice_decrypt_share(Tb["c_b"])
        d = ring.mulmod(self._k, self._gamma)
        s_ = ring.mulmod(self._k, self._w)
        for j in self.others():
            d = ring.addmod(d, ring.addmod(alpha[(j, "gamma")], self._alice_beta[(j, "gamma")]))
            s_ = ring.addmod(s_, ring.addmod(alpha[(j, "w")], self._alice_beta[(j, "w")]))
        self._delta_own, self._sigma_own = d, s_
        return self.broadcast(R3, {"d": self._ser_scalar(d)})

    # -- round 4: Γ decommit + Schnorr PoK -----------------------------------

    def _decommit_gamma(self) -> RoundMsg:
        A_comp, s_pok = gb._blk_schnorr_prove(
            self._wide_scalar(), self._gamma, self._Gamma_comp, self._bind_row(self.self_id))
        return self.broadcast(R4, {"G": _hex(self._Gamma_comp), "blind": _hex(self._gblind),
                                   "A": _hex(A_comp), "spok": self._ser_scalar(s_pok)})

    # -- round 5A ------------------------------------------------------------

    def _phase5a(self) -> RoundMsg:
        ring = self.ring
        delta = self._delta_own
        Gamma_sum = self._Gamma_own
        commits = self._round_payloads(R1B)
        for j in self.others():
            p = self._round_payloads(R4)[j]
            bind = self._bind_row(j)
            G_comp, G_pt = self._parse_point_block(p["G"], j)
            blind = self._block(p["blind"], 32, j)
            commit = self._block(commits[j]["gc"], 32, j)
            self._ok = self._ok & gb._blk_gamma_check(blind, G_comp, bind, commit)
            A_comp = self._block(p["A"], 33, j)
            s_pok = self._parse_scalar(p["spok"], j)
            self._ok = self._ok & gb._blk_schnorr_verify(A_comp, s_pok, G_pt, G_comp, bind)
            delta = ring.addmod(delta, self._parse_scalar(self._round_payloads(R3)[j]["d"], j))
            Gamma_sum = sp.add(Gamma_sum, G_pt)
        ok_R, R_pt, r, rec = gb._blk_R(delta, Gamma_sum)
        self._ok = self._ok & ok_R
        self._R_pt, self._r, self._rec = R_pt, r, rec
        self._li = self._wide_scalar()
        self._rho = self._wide_scalar()
        self._ka = self._wide_scalar()
        self._kb = self._wide_scalar()
        self._va_blind = self._blind()
        si, Vi, Ai, vc, ac, cmt = gb._blk_va(
            self.m, r, self._k, self._sigma_own, self._li, self._rho, R_pt,
            self._va_blind, self._bind_row(self.self_id))
        self._s_own, self._V_own, self._A_own = si, Vi, Ai
        self._vc, self._ac = vc, ac
        return self.broadcast(R5, {"c": _hex(cmt)})

    # -- round 5B ------------------------------------------------------------

    def _phase5b(self) -> RoundMsg:
        Apok, sa, sb = gb._blk_pedersen_prove(
            self._ka, self._kb, self._s_own, self._li, self._R_pt, self._vc, self._ac,
            self._bind_row(self.self_id))
        return self.broadcast(R6, {
            "vc": _hex(self._vc), "ac": _hex(self._ac), "blind": _hex(self._va_blind),
            "apok": _hex(Apok), "sa": self._ser_scalar(sa), "sb": self._ser_scalar(sb),
        })

    # -- round 5C ------------------------------------------------------------

    def _phase5c(self) -> RoundMsg:
        V_sum, A_sum = self._V_own, self._A_own
        for j in self.others():
            p = self._round_payloads(R6)[j]
            bind = self._bind_row(j)
            vc, V_pt = self._parse_point_block(p["vc"], j)
            ac, A_pt = self._parse_point_block(p["ac"], j)
            blind = self._block(p["blind"], 32, j)
            commit = self._block(self._round_payloads(R5)[j]["c"], 32, j)
            self._ok = self._ok & gb._blk_va_check(blind, vc, ac, bind, commit)
            apok = self._block(p["apok"], 33, j)
            self._ok = self._ok & gb._blk_pedersen_verify(
                apok, self._parse_scalar(p["sa"], j), self._parse_scalar(p["sb"], j),
                V_pt, self._R_pt, vc, ac, bind)
            V_sum = sp.add(V_sum, V_pt)
            A_sum = sp.add(A_sum, A_pt)
        V = gb._blk_V(V_sum, self.m, self._r, self.Y)
        self._ut_blind = self._blind()
        Ui, Ti, uc, tc, cmt = gb._blk_ut(self._rho, self._li, V, A_sum, self._ut_blind,
                                         self._bind_row(self.self_id))
        self._U_own, self._T_own = Ui, Ti
        self._uc, self._tc = uc, tc
        return self.broadcast(R7, {"c": _hex(cmt)})

    # -- round 5D ------------------------------------------------------------

    def _phase5d(self) -> RoundMsg:
        return self.broadcast(R8, {"uc": _hex(self._uc), "tc": _hex(self._tc),
                                   "blind": _hex(self._ut_blind)})

    # -- round 5E ------------------------------------------------------------

    def _partial(self) -> RoundMsg:
        U_s, T_s = self._U_own, self._T_own
        for j in self.others():
            p = self._round_payloads(R8)[j]
            uc, U_pt = self._parse_point_block(p["uc"], j)
            tc, T_pt = self._parse_point_block(p["tc"], j)
            blind = self._block(p["blind"], 32, j)
            commit = self._block(self._round_payloads(R7)[j]["c"], 32, j)
            self._ok = self._ok & gb._blk_ut_check(blind, uc, tc, self._bind_row(j), commit)
            U_s = sp.add(U_s, U_pt)
            T_s = sp.add(T_s, T_pt)
        self._ok = self._ok & sp.equal(U_s, T_s)
        return self.broadcast(R9, {"s": self._ser_scalar(self._s_own)})

    def _finalize(self) -> None:
        s = self._s_own
        for j in self.others():
            s = self.ring.addmod(s, self._parse_scalar(self._round_payloads(R9)[j]["s"], j))

        # combine + verify per cohort: one cohort's signature egress (host
        # byte packing) overlaps the next cohort's device step
        def make_job(ci: int, sl: slice):
            def job():
                with tracing.span("phase:gg18_finalize", node=self.self_id,
                                  batch=sl.stop - sl.start, cohort=ci):
                    st = gb._step_final(
                        {"s": s[sl], "m": self.m[sl], "r": self._r[sl], "rec": self._rec[sl],
                         "ok": self._ok[sl]}, gb._slice_pt(self.Y, sl))
                    tracing.span_sync(self.device)
                return (yield ("sig_egress",
                               lambda: gb._sig_egress(st["r"], st["s"], st["rec"], st["ok"])))

            return job

        outs = pl.run_counter_phase(
            [make_job(ci, sl) for ci, sl in enumerate(self._plan.slices())])
        self.result = {key: pl.merge_rows([o[key] for o in outs])
                       for key in ("r", "s", "recovery", "ok")}
        self.done = True
