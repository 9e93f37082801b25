"""Distributed batched DKG and resharing: one protocol instance creates
(or rotates) B wallets concurrently.

The port of ``mpcium_tpu/protocol/batch_dkg.py``, the node-side face of
:mod:`engine.dkg_batch`: parties exchange fixed-shape byte blocks —
(B·32)-byte sub-share blocks, (B·(t+1)·w)-byte Feldman commitment
blocks — and compute every round with the batched blocks on ``device``.

Curve-generic (ed25519 and secp256k1). For secp256k1 the per-node
Paillier/ring-Pedersen material is batch-independent: it is exchanged
and proven once per batch (two DLN proofs in round 1, the Paillier
validity proof in round 2), host python ints as in the JAX package.

DKG wire schedule:

  R1  broadcast   hash-commitment block to the Feldman commitments
                  [+ secp: paillier N, NTilde/h1/h2, two DLN proofs]
  R2  broadcast   decommit: commitment-point block + blind block
                  [+ secp: Paillier validity proof]
      unicast→j   sub-share block f_i(x_j) (B·32)
  finalize        binding + Feldman VSS + proof checks, aggregate

Resharing wire schedule (the old quorum re-deals to the new committee;
public keys are preserved; the epoch increments):

  R1  broadcast (old)   commitment block (coefficient 0 = λ_i·x_i)
  R2  broadcast (old)   decommit; unicast→new: sub-share block
  R3  broadcast (new)   confirm [+ secp: the new member's Paillier
                        material and proofs]
  finalize              new members aggregate and rebuild aux; old-only
                        members finish on the confirms with no result

Any failure raises :class:`ProtocolError` with the culprit named and
aborts the whole batch: a partially created wallet set must not be
persisted (unlike signing, whose failures clear single lanes). Round
names, payload fields, the commitment layout and the proof binding
``"{session}:{sender}"`` are the JAX package's byte for byte.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import bignum as bn
from ..core import hostmath as hm
from ..core.bignum import P256
from ..core.paillier import PaillierPublicKey, PreParams
from ..device import resolve
from ..engine import pipeline as pl
from ..engine.dkg_batch import (
    SCALAR_BITS, _blk_vss_check, _cat_pts, _curve, _rand_scalars, _subshare_phase, _xj_bits,
)
from ..ops.sha256 import sha256 as dev_sha256
from ..utils import tracing
from .base import BatchBlockMixin, KeygenShare, PartyBase, ProtocolError, RoundMsg, party_xs
from .ecdsa.keygen import MIN_PAILLIER_BITS
from .ecdsa.zk import DLNProof, PaillierProof

DKG_R1 = "dkg/b/1/commit"
DKG_R2B = "dkg/b/2/reveal"
DKG_R2S = "dkg/b/2/share"

RS_R1 = "reshare/b/1/commit"
RS_R2B = "reshare/b/2/reveal"
RS_R2S = "reshare/b/2/share"
RS_R3 = "reshare/b/3/confirm"


def _comp_width(key_type: str) -> int:
    return 33 if key_type == "secp256k1" else 32


def _blk_deal_commit(coeffs: torch.Tensor, blind: torch.Tensor, bind_row: torch.Tensor,
                     key_type: str):
    """Own dealing: coeffs (t+1, B, 22) → (commitment points (t+1, B),
    compressed block (B, (t+1)·w), hash-commitment block (B, 32))."""
    mod, _ = _curve(key_type)
    pts = mod.base_mul(bn.limbs_to_bits(coeffs, P256, SCALAR_BITS))
    comp = mod.compress(pts)  # (t+1, B, w)
    block = comp.transpose(0, 1).reshape(comp.shape[1], -1)
    return pts, block, dev_sha256(torch.cat([bind_row, blind, block], dim=-1))


def _blk_commit_check(bind_row, blind, block, commit) -> torch.Tensor:
    got = dev_sha256(torch.cat([bind_row, blind, block], dim=-1))
    return torch.all(got == commit, dim=-1)


def _material_payload(pre: PreParams, rng, bind: bytes) -> Dict:
    """A node's Paillier modulus, ring-Pedersen parameters and the two
    DLN proofs (h2 = h1^α, h1 = h2^β), drawn from ``rng`` in that order."""
    pq = (pre.P - 1) // 2 * ((pre.Q - 1) // 2)
    return {
        "paillier_n": str(pre.paillier.N), "ntilde": str(pre.NTilde),
        "h1": str(pre.h1), "h2": str(pre.h2),
        "dln1": DLNProof.prove(pre.h1, pre.h2, pre.alpha, pq, pre.NTilde, rng,
                               bind=bind).to_json(),
        "dln2": DLNProof.prove(pre.h2, pre.h1, pre.beta, pq, pre.NTilde, rng,
                               bind=bind).to_json(),
    }


def _own_aux(pre: PreParams) -> Dict:
    return {
        "paillier_sk": pre.paillier.to_json(),
        "preparams": {"ntilde": str(pre.NTilde), "h1": str(pre.h1), "h2": str(pre.h2)},
    }


class _DealingMixin(BatchBlockMixin):
    """Block (de)serialization and the Feldman machinery shared by the
    two parties (binding row and block parsing from BatchBlockMixin)."""

    key_type: str
    B: int
    tp1: int
    min_paillier_bits: int

    def _proof_bind(self, sender: str) -> bytes:
        return f"{self.session_id}:{sender}".encode()

    def _ser_scalars(self, x: torch.Tensor) -> str:
        return bn.limbs_to_bytes_le(x, P256, 32).cpu().numpy().tobytes().hex()

    def _parse_scalars(self, hexstr: str, pid: str) -> torch.Tensor:
        arr = torch.as_tensor(self._parse_block(hexstr, 32, pid), device=self.device)
        mod, _ = _curve(self.key_type)
        return mod.scalar_ring(self.device).reduce(bn.bytes_to_limbs_le(arr, P256, 22))

    def _deal(self, coeffs: np.ndarray, plan: pl.CohortPlan) -> str:
        """Commit to this dealer's coefficients (drawn full-batch by the
        caller), cohort by cohort → the hex commitment block; keeps the
        points and the compressed block for the reveal."""
        self._coeffs = torch.as_tensor(coeffs, device=self.device)
        self._blind = torch.as_tensor(
            np.frombuffer(self.rng.token_bytes(self.B * 32), dtype=np.uint8)
            .reshape(self.B, 32).copy(), device=self.device)
        bind = self._bind_row(self.self_id)

        def make_job(ci: int, sl: slice):
            def job():
                with tracing.span("phase:deal_commit", node=self.self_id,
                                  batch=sl.stop - sl.start, cohort=ci):
                    pts, block, commit = _blk_deal_commit(
                        self._coeffs[:, sl], self._blind[sl], bind[sl], self.key_type)
                    tracing.span_sync(self.device)
                commit_host = yield ("commit_egress", lambda: commit.cpu().numpy())
                return pts, block, commit_host

            return job

        outs = pl.run_counter_phase([make_job(ci, sl) for ci, sl in enumerate(plan.slices())])
        self._pts = _cat_pts([o[0] for o in outs], dim=1)
        self._block = torch.cat([o[1] for o in outs], dim=0)
        return np.concatenate([o[2] for o in outs], axis=0).tobytes().hex()

    def _reveal(self) -> Dict:
        return {"points": self._block.cpu().numpy().tobytes().hex(),
                "blind": self._blind.cpu().numpy().tobytes().hex()}

    def _decompress_dealer_points(self, block: np.ndarray, pid: str):
        """(B, (t+1)·w) compressed block → points (t+1, B); one bad
        encoding in the batch is the dealer's ProtocolError."""
        mod, _ = _curve(self.key_type)
        w = _comp_width(self.key_type)
        comp = torch.as_tensor(block.reshape(self.B, self.tp1, w).transpose(1, 0, 2).copy(),
                               device=self.device)
        pts, ok = mod.decompress(comp)
        if not bool(ok.all()):
            raise ProtocolError("bad commitment point in batch", pid)
        return pts

    def _verify_dealer(self, pid: str, commit_hex: str, reveal: Dict,
                       subshare: torch.Tensor, self_x: int):
        """Binding and Feldman VSS of one dealer → their commitment points."""
        block_np = self._parse_block(reveal["points"], self.tp1 * _comp_width(self.key_type),
                                     pid)
        blind = torch.as_tensor(self._parse_block(reveal["blind"], 32, pid), device=self.device)
        commit = torch.as_tensor(self._parse_block(commit_hex, 32, pid), device=self.device)
        ok = _blk_commit_check(self._bind_row(pid), blind,
                               torch.as_tensor(block_np, device=self.device), commit)
        if not bool(ok.all()):
            raise ProtocolError("dealing decommitment mismatch", pid)
        pts = self._decompress_dealer_points(block_np, pid)
        okv = _blk_vss_check(subshare, pts, _xj_bits([self_x], self.device)[0], self.key_type)
        if not bool(okv.all()):
            raise ProtocolError("Feldman VSS share verification failed", pid)
        return pts

    def _peer_material(self, pid: str, p: Dict, require_paillier_proof: bool):
        """Check a peer's Paillier modulus, ring-Pedersen parameters and
        proofs → (N, {ntilde, h1, h2})."""
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
        if require_paillier_proof:
            self._check_paillier_proof(pid, N, p["paillier_proof"])
        return N, {"ntilde": ntilde, "h1": h1, "h2": h2}

    def _check_paillier_proof(self, pid: str, N: int, proof_json: Dict) -> None:
        """The validity proof is verified for a full-size modulus; a test
        modulus below 2046 bits only has to carry one."""
        proof = PaillierProof.from_json(proof_json)
        if N.bit_length() >= 2046:
            if not proof.verify(PaillierPublicKey(N), bind=self._proof_bind(pid)):
                raise ProtocolError("Paillier validity proof failed", pid)
        elif not proof.ys:
            raise ProtocolError("missing Paillier proof", pid)


class BatchedDKGParty(_DealingMixin, PartyBase):
    """One node's side of a B-wallet batched DKG on one curve, computing
    on ``device`` (None: the GPU; raises when there is none — pass
    ``device="cpu"`` for the plain CPU path)."""

    def __init__(
        self,
        session_id: str,
        self_id: str,
        party_ids: Sequence[str],
        threshold: int,
        key_type: str,
        n_wallets: int,
        preparams: Optional[PreParams] = None,
        min_paillier_bits: int = MIN_PAILLIER_BITS,
        rng=None,
        cohorts: Optional[int] = None,
        device=None,
    ):
        import secrets as _secrets

        self.device = resolve(device)
        super().__init__(session_id, self_id, party_ids, rng or _secrets)
        if not 0 < threshold < len(party_ids):
            raise ValueError("need 0 < t < n")
        if n_wallets < 1:
            raise ValueError("need at least one wallet")
        if key_type == "secp256k1" and preparams is None:
            raise ValueError("secp256k1 batched DKG requires preparams")
        self.threshold = threshold
        self.tp1 = threshold + 1
        self.key_type = key_type
        self.B = n_wallets
        self.pre = preparams
        self.min_paillier_bits = min_paillier_bits
        self._plan = pl.CohortPlan.for_batch(self.B, cohorts)
        self._stage = 0

    @torch.inference_mode()
    def start(self) -> List[RoundMsg]:
        _, order = _curve(self.key_type)
        payload = {"commit": self._deal(_rand_scalars((self.tp1, self.B), order, self.rng),
                                        self._plan)}
        if self.key_type == "secp256k1":
            with self._phase("dkg_material_proofs"):
                payload.update(_material_payload(self.pre, self.rng,
                                                 self._proof_bind(self.self_id)))
        self._stage = 1
        return [self.broadcast(DKG_R1, payload)]

    def receive(self, msg: RoundMsg) -> List[RoundMsg]:
        if self.done:
            return []
        self._store(msg)
        others = self.others()
        out: List[RoundMsg] = []
        with torch.inference_mode():
            if self._stage == 1 and self._round_full(DKG_R1, others):
                out.extend(self._reveal_and_deal())
                self._stage = 2
            if (self._stage == 2 and self._round_full(DKG_R2B, others)
                    and self._round_full(DKG_R2S, others)):
                self._finalize()
        return out

    def _reveal_and_deal(self) -> List[RoundMsg]:
        if self.key_type == "secp256k1":
            with self._phase("dkg_verify_material"):
                r1 = self._round_payloads(DKG_R1)
                self._peer_pk: Dict[str, int] = {}
                self._peer_rp: Dict[str, Dict[str, int]] = {}
                for pid in self.others():
                    self._peer_pk[pid], self._peer_rp[pid] = self._peer_material(
                        pid, r1[pid], require_paillier_proof=False)
        payload = self._reveal()
        if self.key_type == "secp256k1":
            payload["paillier_proof"] = PaillierProof.prove(
                self.pre.paillier, bind=self._proof_bind(self.self_id)).to_json()
        out = [self.broadcast(DKG_R2B, payload)]
        with self._phase("dkg_subshares"):
            xs_tuple = tuple(self.xs[p] for p in self.party_ids)
            subs = _subshare_phase(self._coeffs[None], self.key_type, xs_tuple)[0]
            self._own_sub = {pid: subs[i] for i, pid in enumerate(self.party_ids)}
            for pid in self.others():
                out.append(self.unicast(pid, DKG_R2S,
                                        {"share": self._ser_scalars(self._own_sub[pid])}))
        return out

    def _finalize(self) -> None:
        mod, order = _curve(self.key_type)
        ring = mod.scalar_ring(self.device)
        r1 = self._round_payloads(DKG_R1)
        r2b = self._round_payloads(DKG_R2B)
        r2s = self._round_payloads(DKG_R2S)
        if self.key_type == "secp256k1":
            with self._phase("dkg_verify_paillier_proofs"):
                for pid in self.others():
                    self._check_paillier_proof(pid, self._peer_pk[pid],
                                               r2b[pid]["paillier_proof"])
        with self._phase("dkg_verify_aggregate"):
            agg_share = self._own_sub[self.self_id]
            agg_pts = self._pts
            for pid in self.others():
                sub = self._parse_scalars(r2s[pid]["share"], pid)
                pts = self._verify_dealer(pid, r1[pid]["commit"], r2b[pid], sub, self.self_x)
                agg_share = ring.addmod(agg_share, sub)
                agg_pts = mod.add(agg_pts, pts)
            agg_comp = mod.compress(agg_pts).cpu().numpy()  # (t+1, B, w)
            share_ints = bn.batch_from_limbs(agg_share, P256)
        aux: Dict = {}
        if self.key_type == "secp256k1":
            aux = _own_aux(self.pre)
            aux["peer_paillier"] = {pid: str(N) for pid, N in self._peer_pk.items()}
            aux["peer_ring_pedersen"] = {pid: {k: str(v) for k, v in rp.items()}
                                         for pid, rp in self._peer_rp.items()}
        shares: List[KeygenShare] = []
        for w in range(self.B):
            if share_ints[w] % order == 0:
                raise ProtocolError("degenerate share in batch")
            shares.append(KeygenShare(
                key_type=self.key_type, share=share_ints[w], self_x=self.self_x,
                public_key=agg_comp[0, w].tobytes(),
                vss_commitments=[agg_comp[k, w].tobytes() for k in range(self.tp1)],
                participants=list(self.party_ids), threshold=self.threshold, aux=dict(aux),
            ))
        self.result = shares
        self.done = True


class BatchedReshareParty(_DealingMixin, PartyBase):
    """One node's side of a B-wallet batched committee rotation.

    ``old_shares``: this node's current shares (old-quorum members only;
    wallet order = manifest order). New members receive fresh shares with
    epoch + 1, the public keys verified unchanged. ``result`` is the list
    of new shares for a new-committee member, None for an old-only one."""

    def __init__(
        self,
        session_id: str,
        self_id: str,
        key_type: str,
        old_quorum: Sequence[str],
        new_committee: Sequence[str],
        new_threshold: int,
        n_wallets: int,
        old_shares: Optional[Sequence[KeygenShare]] = None,
        old_public_keys: Optional[Sequence[bytes]] = None,
        preparams: Optional[PreParams] = None,
        min_paillier_bits: int = MIN_PAILLIER_BITS,
        old_epoch: int = 0,
        rng=None,
        cohorts: Optional[int] = None,
        device=None,
    ):
        import secrets as _secrets

        self.device = resolve(device)
        all_ids = sorted(set(old_quorum) | set(new_committee))
        super().__init__(session_id, self_id, all_ids, rng or _secrets)
        self.key_type = key_type
        self.old_quorum = sorted(old_quorum)
        self.new_committee = sorted(new_committee)
        self.is_old = self_id in self.old_quorum
        self.is_new = self_id in self.new_committee
        self.t_new = new_threshold
        self.tp1 = new_threshold + 1
        self.B = n_wallets
        self.pre = preparams
        self.min_paillier_bits = min_paillier_bits
        self.old_epoch = old_epoch
        self.new_epoch = old_epoch + 1
        if not 0 < new_threshold < len(self.new_committee):
            raise ValueError("need 0 < t_new < |new committee|")
        if self.is_old:
            if old_shares is None or len(old_shares) != n_wallets:
                raise ProtocolError("old member requires one share per wallet")
            for s in old_shares:
                if s.key_type != key_type or s.epoch != old_epoch:
                    raise ProtocolError("stale/mismatched share for reshare")
            self.old_shares = list(old_shares)
            old_public_keys = [s.public_key for s in old_shares]
        if old_public_keys is None or len(old_public_keys) != n_wallets:
            raise ProtocolError("old public keys required for binding check")
        self.old_pubs = [bytes(p) for p in old_public_keys]
        if key_type == "secp256k1" and self.is_new and preparams is None:
            raise ValueError("secp256k1 reshare requires preparams (new member)")
        self._plan = pl.CohortPlan.for_batch(self.B, cohorts)
        self._stage = 0
        self._confirm_sent = False

    @torch.inference_mode()
    def start(self) -> List[RoundMsg]:
        self._stage = 1
        if not self.is_old:
            return []
        _, order = _curve(self.key_type)
        old_xs = party_xs(self.old_shares[0].participants)
        lam = hm.lagrange_coeff([old_xs[p] for p in self.old_quorum],
                                old_xs[self.self_id], order)
        coeffs = _rand_scalars((self.tp1, self.B), order, self.rng)
        coeffs[0] = bn.batch_to_limbs([lam * s.share % order for s in self.old_shares], P256)
        return [self.broadcast(RS_R1, {"commit": self._deal(coeffs, self._plan)})]

    def receive(self, msg: RoundMsg) -> List[RoundMsg]:
        if self.done:
            return []
        self._store(msg)
        with torch.inference_mode():
            return self._advance()

    def _advance(self) -> List[RoundMsg]:
        out: List[RoundMsg] = []
        old_others = [p for p in self.old_quorum if p != self.self_id]
        new_others = [p for p in self.new_committee if p != self.self_id]
        if self._stage == 1 and self.is_old and self._round_full(RS_R1, old_others):
            out.append(self.broadcast(RS_R2B, self._reveal()))
            new_xs = party_xs(self.new_committee)
            with self._phase("reshare_subshares"):
                subs = _subshare_phase(self._coeffs[None], self.key_type,
                                       tuple(new_xs[p] for p in self.new_committee))[0]
                for i, pid in enumerate(self.new_committee):
                    if pid == self.self_id:
                        self._own_sub = subs[i]
                    else:
                        out.append(self.unicast(pid, RS_R2S,
                                                {"share": self._ser_scalars(subs[i])}))
            self._stage = 2
        if (self.is_new and not self._confirm_sent
                and all(self._round_full(r, old_others) for r in (RS_R1, RS_R2B, RS_R2S))
                and (not self.is_old or self._stage >= 2)):
            self._aggregate_new()
            self._confirm_sent = True
            payload: Dict = {"ok": True}
            if self.key_type == "secp256k1":
                with self._phase("reshare_material_proofs"):
                    bind = self._proof_bind(self.self_id)
                    payload.update(_material_payload(self.pre, self.rng, bind))
                    payload["paillier_proof"] = PaillierProof.prove(
                        self.pre.paillier, bind=bind).to_json()
            out.append(self.broadcast(RS_R3, payload))
        if not self.done and self._round_full(RS_R3, new_others) and (
                self._confirm_sent or not self.is_new):
            if self.is_old and not self.is_new and self._stage < 2:
                return out  # not dealt yet: wait
            self._finalize()
        return out

    def _aggregate_new(self) -> None:
        mod, _ = _curve(self.key_type)
        ring = mod.scalar_ring(self.device)
        r1 = self._round_payloads(RS_R1)
        r2b = self._round_payloads(RS_R2B)
        r2s = self._round_payloads(RS_R2S)
        self_x_new = party_xs(self.new_committee)[self.self_id]
        with self._phase("reshare_verify_aggregate"):
            agg_share = agg_pts = None
            for pid in self.old_quorum:
                if pid == self.self_id:
                    sub, pts = self._own_sub, self._pts
                else:
                    sub = self._parse_scalars(r2s[pid]["share"], pid)
                    pts = self._verify_dealer(pid, r1[pid]["commit"], r2b[pid], sub,
                                              self_x_new)
                if agg_share is None:
                    agg_share, agg_pts = sub, pts
                else:
                    agg_share = ring.addmod(agg_share, sub)
                    agg_pts = mod.add(agg_pts, pts)
            comp = mod.compress(agg_pts).cpu().numpy()  # (t+1, B, w)
        # binding: Σ_i C_i0 must equal the old public keys
        for w in range(self.B):
            if comp[0, w].tobytes() != self.old_pubs[w]:
                raise ProtocolError(f"resharing changed the public key for wallet {w}")
        self._agg_share = agg_share
        self._agg_comp = comp

    def _finalize(self) -> None:
        if not self.is_new:
            self.result = None
            self.done = True
            return
        aux: Dict = {"is_reshared": True}
        if self.key_type == "secp256k1":
            r3 = self._round_payloads(RS_R3)
            peer_pk: Dict[str, str] = {}
            peer_rp: Dict[str, Dict[str, str]] = {}
            with self._phase("reshare_verify_material"):
                for pid in self.new_committee:
                    if pid == self.self_id:
                        continue
                    N, rp = self._peer_material(pid, r3[pid], require_paillier_proof=True)
                    peer_pk[pid] = str(N)
                    peer_rp[pid] = {k: str(v) for k, v in rp.items()}
            aux.update(_own_aux(self.pre))
            aux["peer_paillier"] = peer_pk
            aux["peer_ring_pedersen"] = peer_rp
        self_x = party_xs(self.new_committee)[self.self_id]
        share_ints = bn.batch_from_limbs(self._agg_share, P256)
        self.result = [
            KeygenShare(
                key_type=self.key_type, share=share_ints[w], self_x=self_x,
                public_key=self.old_pubs[w],
                vss_commitments=[self._agg_comp[k, w].tobytes() for k in range(self.tp1)],
                participants=list(self.new_committee), threshold=self.t_new,
                epoch=self.new_epoch, aux=aux,
            )
            for w in range(self.B)
        ]
        self.done = True
