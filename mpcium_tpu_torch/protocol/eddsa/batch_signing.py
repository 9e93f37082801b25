"""Distributed batched threshold-Ed25519 signing: one protocol instance
signs B wallets' messages concurrently.

The port of ``mpcium_tpu/protocol/eddsa/batch_signing.py``: parties
exchange fixed-shape byte blocks — (B·32)-byte commitment, nonce and
partial-signature blocks — and compute each round with the batched
engine (``engine/eddsa_batch``) on ``device``, or, under an armed session
mesh, piece by piece on the mesh's devices (``eddsa_batch.to_dev``).

Protocol (the 3-round commit–reveal threshold Schnorr, over the batch):

  R1 (broadcast) hash commitment to this party's (B, 32) nonce block
  R2 (broadcast) decommit: nonce block + blind
  R3 (broadcast) partial-signature block (B, 32)
  finalize       combine + batched RFC 8032 verification → per-session ok

A failed session (bad point, verification miss) fails only its lane;
commitment fraud aborts the whole batch with the culprit named. Round
names, payload fields and the commitment domain are the JAX package's
byte for byte, so a GPU node and a TPU node can sit in one committee.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...core import bignum as bn
from ...core import hostmath as hm
from ...device import resolve
from ...engine import eddsa_batch as eb
from ...engine import pipeline as pl
from ...utils import tracing
from ..base import KeygenShare, PartyBase, ProtocolError, RoundMsg, party_xs

R1_COMMIT = "eddsa/bsign/1/commit"
R2_REVEAL = "eddsa/bsign/2/reveal"
R3_PARTIAL = "eddsa/bsign/3/partial"


def _block_commit(blind: bytes, block: bytes, bind: bytes) -> str:
    return hashlib.sha256(b"mpcium-tpu/bsign/" + bind + blind + block).hexdigest()


class BatchedEDDSASigningParty(PartyBase):
    """One signer's side of a B-session batch, computing on ``device``
    (None: the GPU; raises when there is none — pass ``device="cpu"``
    for the plain CPU path).

    ``shares``: this node's key shares, one per wallet (batch order is
    the manifest order, identical on every quorum member). ``messages``:
    the B messages to sign. All wallets share the signing quorum
    (``party_ids``); universes may differ per wallet (λ is computed per
    wallet from its own keygen universe).
    """

    def __init__(
        self,
        session_id: str,
        self_id: str,
        party_ids: Sequence[str],
        shares: Sequence[KeygenShare],
        messages: Sequence[bytes],
        rng=None,
        cohorts: Optional[int] = None,
        device=None,
    ):
        import secrets as _secrets

        self.device = resolve(device)
        super().__init__(session_id, self_id, party_ids, rng or _secrets)
        self._cohorts = cohorts
        if len(shares) != len(messages) or not shares:
            raise ValueError("one share per message required")
        self.B = len(shares)
        self.messages = [bytes(m) for m in messages]
        lamx = []
        for s in shares:
            if s.key_type != "ed25519":
                raise ProtocolError("wrong key type for EdDSA batch signing")
            if len(party_ids) < s.threshold + 1:
                raise ProtocolError("not enough participants for threshold")
            xs = party_xs(s.participants)
            for pid in party_ids:
                if pid not in xs:
                    raise ProtocolError("signer not in keygen universe", pid)
            if xs[self_id] != s.self_x:
                raise ProtocolError("share does not belong to this node")
            quorum_xs = [xs[p] for p in self.party_ids]
            lam = hm.lagrange_coeff(quorum_xs, xs[self_id], hm.ED_L)
            lamx.append(lam * s.share % hm.ED_L)
        self.lamx = eb.scalars_to_limb_batch(lamx)
        self.A_comp = np.stack([np.frombuffer(s.public_key, dtype=np.uint8) for s in shares])
        self._stage = 0

    # -- rounds --------------------------------------------------------------

    def _bind(self) -> bytes:
        return f"{self.session_id}:{self.self_id}".encode()

    def start(self) -> List[RoundMsg]:
        # nonces for the full batch are drawn first, then row-sliced per
        # cohort, so wire blocks are bit-identical for every cohort count
        self._plan = pl.CohortPlan.for_batch(self.B, self._cohorts)
        r64 = eb.fresh_nonce_bytes(self.B, self.rng)

        def make_job(ci: int, sl: slice):
            def job():
                with tracing.span("phase:bsign_nonce_commit",
                                  batch=sl.stop - sl.start, cohort=ci):
                    outs = [eb.nonce_commitments(p)
                            for p in eb.to_dev(r64[sl], device=self.device)]
                    tracing.span_sync(self.device)
                block = yield ("nonce_egress",
                               lambda: eb.gather_host([o[1] for o in outs]).tobytes())
                return [o[0] for o in outs], block

            return job

        with torch.inference_mode():
            outs = pl.run_counter_phase(
                [make_job(ci, sl) for ci, sl in enumerate(self._plan.slices())]
            )
        self._r_limbs_c = [r for r, _ in outs]
        self._R_block = b"".join(blk for _, blk in outs)  # B·32 bytes
        self._blind = self.rng.token_bytes(32)
        commit = _block_commit(self._blind, self._R_block, self._bind())
        self._stage = 1
        return [self.broadcast(R1_COMMIT, {"commit": commit})]

    def receive(self, msg: RoundMsg) -> List[RoundMsg]:
        if self.done:
            return []
        self._store(msg)
        others = self.others()
        out: List[RoundMsg] = []
        if self._stage == 1 and self._round_full(R1_COMMIT, others):
            out.append(self.broadcast(
                R2_REVEAL, {"R": self._R_block.hex(), "blind": self._blind.hex()}
            ))
            self._stage = 2
        if self._stage == 2 and self._round_full(R2_REVEAL, others):
            out.append(self._round3())
            self._stage = 3
        if self._stage == 3 and self._round_full(R3_PARTIAL, others):
            self._finalize()
        return out

    def _peer_blocks(self, round_name: str, field: str, nbytes: int) -> Dict[str, bytes]:
        payloads = self._round_payloads(round_name)
        out = {}
        for pid, p in payloads.items():
            b = bytes.fromhex(p[field])
            if len(b) != nbytes:
                raise ProtocolError(f"bad {field} block size", pid)
            out[pid] = b
        return out

    def _round3(self) -> RoundMsg:
        commits = self._round_payloads(R1_COMMIT)
        reveals = self._round_payloads(R2_REVEAL)
        R_blocks: List[bytes] = []
        for pid in self.party_ids:
            if pid == self.self_id:
                R_blocks.append(self._R_block)
                continue
            blk = bytes.fromhex(reveals[pid]["R"])
            if len(blk) != self.B * 32:
                raise ProtocolError("bad nonce block size", pid)
            bind = f"{self.session_id}:{pid}".encode()
            if (_block_commit(bytes.fromhex(reveals[pid]["blind"]), blk, bind)
                    != commits[pid]["commit"]):
                raise ProtocolError("nonce commitment fraud", pid)
            R_blocks.append(blk)
        R_all = np.stack([np.frombuffer(b, dtype=np.uint8).reshape(self.B, 32)
                          for b in R_blocks])

        def make_job(ci: int, sl: slice):
            def job():
                with tracing.span("phase:bsign_aggregate_partial",
                                  batch=sl.stop - sl.start, cohort=ci):
                    dev = self.device
                    agg = [eb.aggregate_nonce(p)
                           for p in eb.to_dev(R_all[:, sl], axis=1, device=dev)]
                    # R enters the challenge hash
                    R_sum_h = eb.gather_host([R_sum for R_sum, _ in agg])
                    c64 = eb.challenge_hashes(R_sum_h, self.A_comp[sl],
                                              self.messages[sl], dev)
                    parts = [eb.partial_signature(r, c, lx) for r, c, lx in zip(
                        self._r_limbs_c[ci], eb.to_dev(c64, device=dev),
                        eb.to_dev(self.lamx[sl], device=dev), strict=True)]
                    tracing.span_sync(self.device)
                egress = yield ("partial_egress", lambda: (
                    eb.gather_host([bn.limbs_to_bytes_le(p, bn.P256, 32) for p in parts]),
                    eb.gather_host([ok_R for _, ok_R in agg]),
                ))
                return R_sum_h, c64, parts, egress

            return job

        with torch.inference_mode():
            outs = pl.run_counter_phase(
                [make_job(ci, sl) for ci, sl in enumerate(self._plan.slices())]
            )
        self._R_sum = pl.merge_rows([o[0] for o in outs])
        self._c64 = pl.merge_rows([o[1] for o in outs])
        self._parts_c = [o[2] for o in outs]
        self._ok_R = pl.merge_rows([o[3][1] for o in outs])
        s_block = pl.merge_rows([o[3][0] for o in outs])
        return self.broadcast(R3_PARTIAL, {"s": s_block.tobytes().hex()})

    def _finalize(self) -> None:
        blocks = self._peer_blocks(R3_PARTIAL, "s", self.B * 32)
        peer_rows = {
            pid: np.frombuffer(blocks[pid], dtype=np.uint8).reshape(self.B, 32)
            for pid in self.party_ids
            if pid != self.self_id
        }

        def make_job(ci: int, sl: slice):
            def job():
                with tracing.span("phase:bsign_combine_verify",
                                  batch=sl.stop - sl.start, cohort=ci):
                    dev = self.device
                    # per piece: this party's partials, then each peer's
                    stacked = [[p] for p in self._parts_c[ci]]
                    for pid in self.party_ids:
                        if pid != self.self_id:
                            for st, p in zip(stacked, eb.to_dev(peer_rows[pid][sl], device=dev),
                                             strict=True):
                                st.append(bn.bytes_to_limbs_le(p, bn.P256, bn.P256.n_limbs))
                    sigs, ok = [], []
                    for st, R, A, c in zip(stacked, eb.to_dev(self._R_sum[sl], device=dev),
                                           eb.to_dev(self.A_comp[sl], device=dev),
                                           eb.to_dev(self._c64[sl], device=dev), strict=True):
                        sig, _s = eb.combine_signatures(torch.stack(st), R)
                        sigs.append(sig)
                        ok.append(eb.verify_signatures(sig, A, c))
                    tracing.span_sync(self.device)
                return (yield ("sig_egress",
                               lambda: (eb.gather_host(sigs), eb.gather_host(ok))))

            return job

        with torch.inference_mode():
            outs = pl.run_counter_phase(
                [make_job(ci, sl) for ci, sl in enumerate(self._plan.slices())]
            )
        self.result = {
            "signatures": pl.merge_rows([o[0] for o in outs]),
            "ok": pl.merge_rows([o[1] for o in outs]) & self._ok_R,
        }
        self.done = True
