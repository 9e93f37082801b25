"""Batched distributed key generation and resharing (PyTorch).

The port of ``mpcium_tpu/engine/dkg_batch.py`` (BASELINE configs 4-5:
a DKG of 4096 wallets and a rotation of 1024): B wallets' Feldman-VSS
arithmetic runs batched per round on ``device``, for both curves:

- polynomial sampling: (B, t+1) scalars per party, drawn on the host;
- Feldman commitments: one fixed-base ladder over every (party, degree,
  wallet) coefficient, and the SHA-256 hash commitment of each party's
  compressed block;
- sub-shares f_i(x_j): Horner over the scalar ring, every (dealer,
  recipient) pair at once;
- sub-share verification f_i(x_j)·G == Σ_k x_j^k·C_ik: point-Horner
  with the tiny public x_j as an 8-bit operand, every pair at once.

For secp256k1 the per-node Paillier/ring-Pedersen material is
independent of the wallet batch and is attached outside this engine,
so both curves share one core. The in-process fabric computes every
party's side (bench and tests); the distributed parties
(``protocol/batch_dkg.py``) run the same blocks per party.
"""
from __future__ import annotations

import secrets
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import bignum as bn
from ..core import ed25519 as ed
from ..core import hostmath as hm
from ..core import secp256k1 as sp
from ..core.bignum import P256
from ..device import resolve
from ..ops.sha256 import sha256 as dev_sha256
from ..protocol.base import KeygenShare, party_xs
from ..utils import tracing
from . import pipeline as pl

SCALAR_BITS = 256


def _curve(key_type: str):
    if key_type == "ed25519":
        return ed, hm.ED_L
    if key_type == "secp256k1":
        return sp, hm.SECP_N
    raise ValueError(key_type)


def _pt(p, idx):
    """Index every coordinate of a point batch."""
    return type(p)(*(c[idx] for c in p))


def _expand_pt(p, shape):
    return type(p)(*(c.expand(tuple(shape) + c.shape[-1:]) for c in p))


def _cat_pts(parts, dim: int):
    """Point batches concatenated along a batch axis."""
    if len(parts) == 1:
        return parts[0]
    return type(parts[0])(*(torch.cat(cs, dim=dim) for cs in zip(*parts)))


def _add(mod, a, b):
    """a + b over broadcast batch shapes."""
    shape = torch.broadcast_shapes(a.batch_shape, b.batch_shape)
    return mod.add(_expand_pt(a, shape), _expand_pt(b, shape))


def _rand_scalars(shape: Tuple[int, ...], order: int, rng) -> np.ndarray:
    """Uniform scalars mod order as limbs: 40 bytes per scalar (wide
    reduction), drawn in row-major order of ``shape``."""
    flat = int(np.prod(shape))
    vals = [int.from_bytes(rng.token_bytes(40), "little") % order for _ in range(flat)]
    return bn.batch_to_limbs(vals, P256).reshape(*shape, P256.n_limbs)


def _dkg_tag(i: int) -> bytes:
    return b"mpcium-tpu/dkg/%d" % i  # wire constant


def _commit_phase(coeffs: torch.Tensor, blinds: torch.Tensor, key_type: str):
    """coeffs (q, t+1, B, 22) → (commitment points (q, t+1, B), hash
    commitments (q, B, 32) of each party's compressed block)."""
    mod, _ = _curve(key_type)
    q = coeffs.shape[0]
    pts = mod.base_mul(bn.limbs_to_bits(coeffs, P256, SCALAR_BITS))
    comp = mod.compress(pts)  # (q, t+1, B, w)
    block = comp.permute(0, 2, 1, 3).reshape(q, comp.shape[2], -1)  # (q, B, (t+1)·w)
    commits = []
    for i in range(q):
        tag = torch.tensor(list(_dkg_tag(i)), dtype=torch.uint8, device=coeffs.device)
        commits.append(dev_sha256(torch.cat(
            [tag.expand(block.shape[1], -1), blinds[i], block[i]], dim=-1)))
    return pts, torch.stack(commits)


def _subshare_phase(coeffs: torch.Tensor, key_type: str, xs: Tuple[int, ...]) -> torch.Tensor:
    """f_i(x_j) for every (party i, recipient j): (q, n_recv, B, 22)."""
    mod, _ = _curve(key_type)
    ring = mod.scalar_ring(coeffs.device)
    q, tp1, B = coeffs.shape[0], coeffs.shape[1], coeffs.shape[2]
    shape = (q, len(xs), B)
    xl = torch.stack([ring.const(xj) for xj in xs])[None, :, None].expand(shape + (-1,))
    acc = coeffs[:, None, tp1 - 1].expand(shape + (-1,))
    for kdeg in range(tp1 - 2, -1, -1):
        acc = ring.addmod(ring.mulmod(acc, xl), coeffs[:, None, kdeg].expand(shape + (-1,)))
    return acc


def _xj_bits(xs: Sequence[int], device) -> torch.Tensor:
    """Participant x-coordinates as 8-bit operand rows (indices are tiny)."""
    assert all(x.bit_length() <= 8 for x in xs)
    return torch.tensor([[(x >> b) & 1 for b in range(8)] for x in xs], dtype=torch.int32,
                        device=device)


def _blk_vss_check(subshare: torch.Tensor, pts, xbits: torch.Tensor,
                   key_type: str) -> torch.Tensor:
    """Feldman check f(x)·G == Σ_k x^k·C_k by point-Horner.

    ``pts``: commitment points with the degree as leading axis (C_0 …
    C_t); ``xbits``: (…, 8) bits of x. Batch shapes broadcast, so one
    call checks any set of (dealer, recipient) pairs."""
    mod, _ = _curve(key_type)
    lhs = mod.base_mul(bn.limbs_to_bits(subshare, P256, SCALAR_BITS))
    tp1 = pts.X.shape[0]
    acc = _pt(pts, tp1 - 1)
    for k in range(tp1 - 2, -1, -1):
        acc = _add(mod, mod.scalar_mul(xbits, acc), _pt(pts, k))
    shape = torch.broadcast_shapes(lhs.batch_shape, acc.batch_shape)
    return mod.equal(_expand_pt(lhs, shape), _expand_pt(acc, shape))


def _verify_phase_points(subshares: torch.Tensor, pts, key_type: str, xs) -> torch.Tensor:
    """Every dealer's sub-share to every recipient against the dealer's
    commitment points → (B,) verdict. ``pts`` (q, t+1, B)."""
    by_degree = type(pts)(*(c.transpose(0, 1)[:, :, None] for c in pts))  # (t+1, q, 1, B)
    xbits = _xj_bits(xs, subshares.device)[None, :, None]  # (1, n, 1, 8)
    ok = _blk_vss_check(subshares, by_degree, xbits, key_type)  # (q, n, B)
    return torch.all(ok.reshape(-1, ok.shape[-1]), dim=0)


def _vss_core(engine: str, key_type: str, xs_tuple: Tuple[int, ...],
              coeffs: torch.Tensor, blinds: torch.Tensor, plan: pl.CohortPlan,
              pt: tracing.PhaseTimer):
    """The shared DKG/reshare round core — commit → subshare → VSS
    verify → aggregate — run per counter-phase cohort.

    All secret material (``coeffs``, ``blinds``) was drawn by the caller
    for the full batch before the split; each cohort only slices it
    along the wallet axis, so shares and commitments are bit-identical
    for every cohort count. ``pt`` is the caller's phase timer: the
    serial path marks it, each cohort of several marks its own (tid
    ``<pt.tid>:c<i>``), their phase dicts added into the caller's.
    Returns ``(ok, agg, comp)`` in batch order: ``ok`` a host (B,)
    verdict row, ``agg`` the aggregated sub-shares (n_recv, B, 22) on
    the host, ``comp`` the aggregate commitment bytes ``[t+1][B]``
    (``comp[0]`` is the public-key row)."""
    mod, _ = _curve(key_type)
    ring = mod.scalar_ring(coeffs.device)

    def rounds(mark, c_coeffs, c_blinds):
        pts, commits = _commit_phase(c_coeffs, c_blinds, key_type)
        mark("commit", commits)
        subshares = _subshare_phase(c_coeffs, key_type, xs_tuple)
        mark("subshare", subshares)
        ok = _verify_phase_points(subshares, pts, key_type, xs_tuple)
        mark("vss_verify", ok)
        agg = subshares[0]
        agg_pts = _pt(pts, 0)
        for i in range(1, subshares.shape[0]):
            agg = ring.addmod(agg, subshares[i])
            agg_pts = mod.add(agg_pts, _pt(pts, i))
        comp = mod.compress(agg_pts)  # (t+1, B', w)
        return lambda: (
            ok.cpu().numpy(),  # mpcflow: host-ok — verdict egress
            bn.limbs_to_numpy(agg),  # mpcflow: host-ok — aggregated shares leave device once per cohort
            comp.cpu().numpy(),  # mpcflow: host-ok — public-point wire serialization (compressed bytes)
        )

    if plan.serial:
        ok, agg, comp = rounds(pt.mark, coeffs, blinds)()
    else:
        cohort_phases = [{} if pt.phases is not None else None for _ in range(plan.k)]

        def job(ci: int, sl: slice):
            def run():
                cpt = tracing.PhaseTimer(
                    engine, tracing.sync_tensors, phase_times=cohort_phases[ci],
                    node="engine", tid=f"{pt.tid}:c{ci}",
                )
                return (yield ("share_egress", rounds(cpt.mark, coeffs[:, :, sl], blinds[:, sl])))

            return run

        outs = pl.run_counter_phase([job(ci, sl) for ci, sl in enumerate(plan.slices())])
        tracing.add_phase_times(pt.phases, cohort_phases)
        # the caller's last phase counts from here: the cohorts' rounds
        # are their own phases
        pt.restart()
        ok = pl.merge_rows([o[0] for o in outs])
        agg = pl.merge_rows([o[1] for o in outs], axis=1)
        comp = pl.merge_rows([o[2] for o in outs], axis=1)
    return ok, agg, [[bytes(c) for c in row] for row in comp]


def _full_batch_blinds(rng, q: int, B: int, device) -> torch.Tensor:
    return torch.as_tensor(
        np.frombuffer(rng.token_bytes(q * B * 32), dtype=np.uint8).reshape(q, B, 32).copy(),
        device=device)


class BatchedDKG:
    """In-process q-party Feldman DKG for B wallets on ``device`` (None:
    the GPU; raises when there is none — pass ``device="cpu"`` for the
    plain CPU path). Bench and test fabric: the distributed node runs
    one side of the same blocks per party."""

    def __init__(self, party_ids: Sequence[str], threshold: int, key_type: str,
                 rng=secrets, *, device=None):
        self.device = resolve(device)
        # caller order: run()'s result[i] belongs to party_ids[i]
        self.ids = list(party_ids)
        self.t = threshold
        self.key_type = key_type
        self.rng = rng
        if not 0 < threshold < len(self.ids):
            raise ValueError("need 0 < t < n")
        self.xs = party_xs(self.ids)

    @torch.inference_mode()
    def run(self, n_wallets: int, cohorts: Optional[int] = None,
            phase_times: Optional[dict] = None) -> List[List[KeygenShare]]:
        """Per-party share lists (result[i] → party_ids[i]), wallet-aligned.
        Raises on any VSS failure. ``cohorts``: the counter-phase cohort
        count (shares are bit-identical for every count); ``phase_times``
        receives wall seconds per phase, synchronizing the device, as the
        ``phase:*`` spans do when tracing is on (phases ``commit``,
        ``subshare``, ``vss_verify``, ``aggregate_assemble``)."""
        _, order = _curve(self.key_type)
        q, t, B = len(self.ids), self.t, n_wallets
        xs_tuple = tuple(self.xs[p] for p in self.ids)
        pt = tracing.PhaseTimer("dkg.run", tracing.sync_tensors, phase_times=phase_times,
                                node="engine", tid=f"dkg:B{B}")
        coeffs = torch.as_tensor(_rand_scalars((q, t + 1, B), order, self.rng),
                                 device=self.device)
        blinds = _full_batch_blinds(self.rng, q, B, self.device)
        ok, agg, comp = _vss_core("dkg.run", self.key_type, xs_tuple, coeffs, blinds,
                                  pl.CohortPlan.for_batch(B, cohorts), pt)
        if not bool(ok.all()):
            raise RuntimeError("batched DKG: VSS verification failed")
        shares_int = [bn.batch_from_limbs(agg[j], P256) for j in range(q)]
        out: List[List[KeygenShare]] = [[] for _ in self.ids]
        for w in range(B):
            vss = [comp[kdeg][w] for kdeg in range(t + 1)]
            for j, pid in enumerate(self.ids):
                out[j].append(KeygenShare(
                    key_type=self.key_type, share=shares_int[j][w], self_x=self.xs[pid],
                    public_key=comp[0][w], vss_commitments=vss,
                    participants=list(self.ids), threshold=t,
                ))
        pt.mark("aggregate_assemble")
        return out


class BatchedReshare:
    """In-process batched committee rotation (BASELINE config 5): an old
    quorum re-deals B wallets' secrets to a new committee under a new
    threshold; public keys unchanged, epoch + 1."""

    def __init__(self, old_quorum: Sequence[str], old_shares: Sequence[Sequence[KeygenShare]],
                 new_committee: Sequence[str], new_threshold: int, rng=secrets, *,
                 device=None):
        self.device = resolve(device)
        self.old_quorum = list(old_quorum)
        self.old_shares = old_shares  # per old-quorum member
        # caller order: run()'s result[j] → new_committee[j]
        self.new_committee = list(new_committee)
        self.t_new = new_threshold
        self.rng = rng
        self.key_type = old_shares[0][0].key_type
        self.B = len(old_shares[0])
        if not 0 < new_threshold < len(self.new_committee):
            raise ValueError("need 0 < t_new < |new committee|")

    @torch.inference_mode()
    def run(self, cohorts: Optional[int] = None,
            phase_times: Optional[dict] = None) -> List[List[KeygenShare]]:
        """Per-new-member share lists; verifies that the redeal binds to
        the old public keys. ``cohorts`` and ``phase_times`` as in
        :meth:`BatchedDKG.run`."""
        _, order = _curve(self.key_type)
        B, t_new = self.B, self.t_new
        q_old = len(self.old_quorum)
        new_xs = party_xs(self.new_committee)
        xs_tuple = tuple(new_xs[p] for p in self.new_committee)
        first = self.old_shares[0][0]
        old_xs = party_xs(first.participants)
        quorum_xs = [old_xs[p] for p in self.old_quorum]
        pt = tracing.PhaseTimer("reshare.run", tracing.sync_tensors, phase_times=phase_times,
                                node="engine", tid=f"reshare:B{B}")
        # coefficient 0 = w_i = λ_i·x_i, drawn first and then overwritten
        coeffs_np = _rand_scalars((q_old, t_new + 1, B), order, self.rng)
        for i, pid in enumerate(self.old_quorum):
            lam = hm.lagrange_coeff(quorum_xs, old_xs[pid], order)
            coeffs_np[i, 0] = bn.batch_to_limbs(
                [lam * s.share % order for s in self.old_shares[i]], P256)
        coeffs = torch.as_tensor(coeffs_np, device=self.device)
        blinds = _full_batch_blinds(self.rng, q_old, B, self.device)
        ok, agg, comp = _vss_core("reshare.run", self.key_type, xs_tuple, coeffs, blinds,
                                  pl.CohortPlan.for_batch(B, cohorts), pt)
        # redeal binding: Σ_i C_i0 must equal the old public key
        for w in range(B):
            if comp[0][w] != self.old_shares[0][w].public_key:
                raise RuntimeError(f"resharing changed the public key for wallet {w}")
        if not bool(ok.all()):
            raise RuntimeError("batched resharing: VSS verification failed")
        shares_int = [bn.batch_from_limbs(agg[j], P256) for j in range(len(self.new_committee))]
        epoch = first.epoch + 1
        out: List[List[KeygenShare]] = [[] for _ in self.new_committee]
        for w in range(B):
            vss = [comp[kdeg][w] for kdeg in range(t_new + 1)]
            for j, pid in enumerate(self.new_committee):
                out[j].append(KeygenShare(
                    key_type=self.key_type, share=shares_int[j][w], self_x=new_xs[pid],
                    public_key=self.old_shares[0][w].public_key, vss_commitments=vss,
                    participants=list(self.new_committee), threshold=t_new, epoch=epoch,
                    aux={"is_reshared": True},
                ))
        pt.mark("aggregate_assemble")
        return out
