"""Batched threshold-Ed25519 signing (PyTorch).

The port of ``mpcium_tpu/engine/eddsa_batch.py``: each MPC party
coalesces the round compute of B concurrent signing sessions into
batched tensor ops on one device. The protocol is the 3-round
commit–reveal threshold Schnorr of the JAX package: round 1 nonce
commitments R_i = r_i·B and SHA-256 commitments to them, round 2
decommit and aggregate R = Σ R_i, round 3 the RFC 8032 challenge
SHA-512(R ‖ A ‖ M) and partial signatures s_i = r_i + c·λ_i·x_i,
combined into s = Σ s_i and verified before they are published.

Wire format for batched rounds is byte tensors: a party's round-1
message is the (B, 32) tensor of compressed nonce points, and so on.
Commitments hash through the device SHA-256 and challenges through the
device SHA-512 (``ops/hash_suite``), so the round tensors stay on the
device; only a ragged message batch hashes its challenges with
``hashlib`` on the host, with the same bytes.

The JAX package's jitted kernels are plain functions here, and its
donated round steps (``round_step_*``) return a new state dict; the
signer takes an explicit ``device`` (None: the GPU, raising when there
is none).

Session-axis sharding (``engine/sharded.arm_session_axis``): torch has
no sharded tensor, so where JAX lets GSPMD partition each dispatch, the
engine splits a batch tensor at ingress (:func:`to_dev`) into one piece
per session device of the armed mesh and runs the round steps piece by
piece, each on its own device; the host egress joins the pieces in
session order (:func:`gather_host`). The bytes are the unsharded ones.
"""
from __future__ import annotations

import hashlib
import secrets
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import bignum as bn
from ..core import ed25519 as ed
from ..core import hostmath as hm
from ..core.bignum import P256 as PROF
from ..device import resolve
from ..ops import hash_suite as hs
from ..utils import tracing
from . import pipeline as pl

# 512-bit inputs (hash outputs, wide nonces) occupy 43 twelve-bit limbs —
# within BarrettCtx.reduce's 2n = 44-limb bound.
_WIDE_LIMBS = 43
# the commitment domain: a wire constant shared with the JAX package
COMMIT_PREFIX = b"mpcium-tpu/eddsa-commit"

# The armed session mesh (engine/sharded.SessionMesh), process-global as
# in the JAX package: with one armed, every batch tensor entering the
# engine is split over its session devices. None: the party's device.
_SESSION_MESH = None


def arm_session_sharding(mesh) -> None:
    """Install (or clear, with None) the mesh :func:`to_dev` splits over;
    span syncs cover its devices from then on. Called by
    ``engine.sharded.arm_session_axis``."""
    global _SESSION_MESH
    _SESSION_MESH = mesh
    tracing.set_mesh_devices(() if mesh is None else mesh.device_set)


def to_dev(x, axis: int = 0, device=None) -> Tuple[torch.Tensor, ...]:
    """Engine ingress: ``x`` (host array or tensor) as one tensor per
    session device of the armed mesh, split along ``axis`` in session
    order. Callers MUST name the session axis: round tensors like
    (q, B, 32) are party-leading, and splitting axis 0 there would split
    the committee. With no mesh armed, or an axis whose length the mesh's
    device count does not divide, one tensor on ``device`` (None: the
    GPU) — JAX's default placement rather than a failed dispatch."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    mesh = _SESSION_MESH
    if mesh is None or t.dim() <= axis or t.shape[axis] % mesh.size:
        return (t.to(resolve(device)),)
    devs = mesh.session_devices
    return tuple(p.to(d) for p, d in zip(t.tensor_split(len(devs), dim=axis), devs))


def gather_host(pieces: Sequence[torch.Tensor], axis: int = 0) -> np.ndarray:
    """Host egress: :func:`to_dev`'s pieces (or results computed from
    them) joined back in session order."""
    return np.concatenate([p.cpu().numpy() for p in pieces], axis=axis)


def _reduce_wide(b64: torch.Tensor) -> torch.Tensor:
    """(…, 64) uint8 little-endian → canonical scalar limbs mod l."""
    L = ed.scalar_ring(b64.device)
    return L.reduce(bn.bytes_to_limbs_le(b64, PROF, _WIDE_LIMBS))


def _bits(s: torch.Tensor) -> torch.Tensor:
    return bn.limbs_to_bits(s, PROF, ed.SCALAR_BITS)


# ---------------------------------------------------------------------------
# round kernels (party-local, batched over sessions)
# ---------------------------------------------------------------------------


def nonce_commitments(r64: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round 1 compute. ``r64``: (..., 64) uint8 of fresh CSPRNG bytes.

    Returns (r limbs mod l, compressed R_i = r·B as (..., 32) uint8). The
    512→252-bit reduction makes the nonce statistically uniform mod l
    (RFC 8032's own wide-reduction trick).
    """
    r = _reduce_wide(r64)
    return r, ed.compress(ed.base_mul(_bits(r)))


def aggregate_nonce(R_all: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, B, 32) compressed nonce shares → ((B, 32) compressed R = Σ R_i,
    (B,) validity mask)."""
    pts, ok = ed.decompress(R_all)
    acc = ed.EdPointJ(*(c[0] for c in pts))
    for i in range(1, R_all.shape[0]):
        acc = ed.add(acc, ed.EdPointJ(*(c[i] for c in pts)))
    return ed.compress(acc), torch.all(ok, dim=0)


def partial_signature(
    r_limbs: torch.Tensor, c64: torch.Tensor, lamx_limbs: torch.Tensor
) -> torch.Tensor:
    """Round 3 compute: s_i = r + H(R‖A‖M)·λ_i·x_i (mod l), batched.

    ``c64``: raw SHA-512 digests (…, 64); ``lamx_limbs``: λ_i·x_i mod l
    as limbs."""
    L = ed.scalar_ring(r_limbs.device)
    return L.addmod(r_limbs, L.mulmod(_reduce_wide(c64), lamx_limbs))


def combine_signatures(
    s_parts: torch.Tensor, R_comp: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, B, 22) partial-signature limbs + (B, 32) R → ((B, 64)
    signatures, (B, 22) s limbs). Layout per RFC 8032: R ‖ s
    little-endian."""
    L = ed.scalar_ring(s_parts.device)
    s = s_parts[0]
    for i in range(1, s_parts.shape[0]):
        s = L.addmod(s, s_parts[i])
    s_bytes = bn.limbs_to_bytes_le(s, PROF, 32)
    return torch.cat([R_comp, s_bytes], dim=-1), s


def verify_signatures(
    sig: torch.Tensor, A_comp: torch.Tensor, c64: torch.Tensor
) -> torch.Tensor:
    """Batched RFC 8032 verification given the challenge hashes
    c64 = SHA512(R‖A‖M): s·B == R + c·A, s < l, R and A valid
    encodings. Returns (B,) bool."""
    dev = sig.device
    pts, ok = ed.decompress(torch.stack([sig[..., :32], A_comp.to(dev)]))
    R_pt, A_pt = (ed.EdPointJ(*(c[i] for c in pts)) for i in (0, 1))
    s = bn.bytes_to_limbs_le(sig[..., 32:], PROF, PROF.n_limbs)
    l_l = torch.as_tensor(bn.to_limbs(hm.ED_L, PROF), device=dev)
    ok_range = bn.compare(s, l_l) < 0
    c = _reduce_wide(c64)
    lhs = ed.base_mul(_bits(s))
    rhs = ed.add(R_pt, ed.scalar_mul(_bits(c), A_pt))
    return ed.equal(lhs, rhs) & ok[0] & ok[1] & ok_range


def fused_sign_step(
    r64: torch.Tensor, c64: torch.Tensor, lamx_limbs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole device side of one batched signing step: nonce scalars
    and commitments, nonce aggregation, partial signatures, combine.
    ``r64`` (q, B, 64); ``c64`` (B, 64) challenge hashes; ``lamx_limbs``
    (q, B, 22). Returns ((B, 64) signatures, (B,) R-valid)."""
    q = r64.shape[0]
    r, R_comp = nonce_commitments(r64)
    R_sum, ok_R = aggregate_nonce(R_comp)
    parts = partial_signature(r, c64.expand((q,) + c64.shape), lamx_limbs)
    sigs, _ = combine_signatures(parts, R_sum)
    return sigs, ok_R


# ---------------------------------------------------------------------------
# round steps (counter-phase cohort pipeline, engine/pipeline.py)
# ---------------------------------------------------------------------------
#
# Per-round session state is an explicit dict; each step returns the next
# round's dict and keeps only what later rounds read, so a cohort's
# earlier round buffers are freed as it advances.


def _commit_msg(pref: torch.Tensor, blinds: torch.Tensor, R_comp: torch.Tensor):
    q, B = R_comp.shape[0], R_comp.shape[1]
    return torch.cat([pref.expand((q, B) + pref.shape), blinds, R_comp], dim=-1)


def round_step_nonce(st: dict, pref: torch.Tensor) -> Dict[str, torch.Tensor]:
    """R1: ``{r64 (q,B,64), blinds (q,B,32)}`` → ``{r, R_comp,
    commit_msg, commits}``."""
    r, R_comp = nonce_commitments(st["r64"])
    commit_msg = _commit_msg(pref, st["blinds"], R_comp)
    return {"r": r, "R_comp": R_comp, "commit_msg": commit_msg,
            "commits": hs.sha256(commit_msg)}


def round_step_aggregate(st: dict) -> Dict[str, torch.Tensor]:
    """R2: re-hash the received commitment tensors (one fraud verdict for
    the batch) and aggregate the nonce points."""
    again = hs.sha256(st["commit_msg"])
    R_sum, ok_R = aggregate_nonce(st["R_comp"])
    return {"r": st["r"], "R_sum": R_sum, "ok_R": ok_R,
            "fraud_free": torch.all(again == st["commits"])}


def round_step_partial(st: dict, c64: torch.Tensor,
                       lamx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """R3: partial signatures + combine."""
    q = st["r"].shape[0]
    parts = partial_signature(st["r"], c64.expand((q,) + c64.shape), lamx)
    sigs, _ = combine_signatures(parts, st["R_sum"])
    return {"sigs": sigs, "ok_R": st["ok_R"], "R_sum": st["R_sum"]}


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def challenge_device(R_comp, A_comp, M, device=None) -> torch.Tensor:
    """SHA-512(R ‖ A ‖ M) over (B, 32)/(B, 32)/(B, L) uint8 rows (tensors
    or host arrays) → (B, 64) digests on ``device`` (default: R_comp's
    device when it is a tensor)."""
    if device is None:
        device = R_comp.device if isinstance(R_comp, torch.Tensor) else resolve(None)
    return hs.sha512(torch.cat([hs.as_bytes(x, device) for x in (R_comp, A_comp, M)], dim=-1))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def challenge_hashes(
    R_comp, A_comp, messages: Sequence[bytes], device=None
) -> np.ndarray:
    """Per-session SHA-512(R ‖ A ‖ M) → (B, 64) uint8 on the host.

    Equal-length messages hash on ``device`` in one batched call
    (:func:`challenge_device`); a ragged batch hashes each row with
    hashlib. Both paths give the same bytes."""
    lens = {len(m) for m in messages}
    if len(lens) == 1:
        M = np.frombuffer(b"".join(messages), np.uint8).reshape(len(messages), lens.pop())
        return challenge_device(R_comp, A_comp, M, device).cpu().numpy()  # mpcflow: host-ok — host-facing helper egress; the batch engine uses challenge_device and keeps c64 on device
    return challenge_hashes_host(R_comp, A_comp, messages)


def challenge_hashes_host(R_comp, A_comp, messages: Sequence[bytes]) -> np.ndarray:
    """Per-session SHA-512(R ‖ A ‖ M) with hashlib → (B, 64) uint8."""
    R, A = _host(R_comp), _host(A_comp)
    out = np.empty((len(messages), 64), dtype=np.uint8)
    for i, m in enumerate(messages):
        out[i] = np.frombuffer(
            hashlib.sha512(R[i].tobytes() + A[i].tobytes() + m).digest(), np.uint8
        )
    return out


def fresh_nonce_bytes(batch: int, rng=secrets) -> np.ndarray:
    """(B, 64) CSPRNG bytes for round 1."""
    return np.frombuffer(rng.token_bytes(batch * 64), dtype=np.uint8).reshape(batch, 64)


def scalars_to_limb_batch(xs: Sequence[int]) -> np.ndarray:
    """Host scalars → (B, 22) int32 limbs of their residues mod l."""
    return bn.batch_to_limbs([x % hm.ED_L for x in xs], PROF)


# ---------------------------------------------------------------------------
# in-process co-signing fabric (bench / tests / loopback deployments)
# ---------------------------------------------------------------------------


class BatchedCoSigners:
    """Drives q parties × B sessions of the 3-round signing protocol with
    batched compute per party per round on ``device`` (None: the GPU;
    raises when there is none — pass ``device="cpu"`` for the plain CPU
    path).

    ``party_shares``: for each of the q quorum parties, that party's
    per-session key shares (length B, same wallet order). All sessions
    must share one quorum topology (same party ids and x-coordinates).
    """

    def __init__(
        self,
        party_ids: Sequence[str],
        party_shares: Sequence[Sequence["KeygenShare"]],  # noqa: F821
        rng=secrets,
        device=None,
    ):
        from ..protocol.base import party_xs

        self.device = resolve(device)
        assert len(party_ids) == len(party_shares) >= 2
        self.party_ids = list(party_ids)
        self.q = len(party_ids)
        self.B = len(party_shares[0])
        assert all(len(s) == self.B for s in party_shares)
        self.rng = rng

        first = party_shares[0][0]
        if self.q < first.threshold + 1:
            raise ValueError("not enough participants for threshold")
        universe_xs = party_xs(first.participants)
        quorum_xs = [universe_xs[p] for p in party_ids]
        # λ_i·x_i per (party, session): λ depends only on the quorum
        # topology, shared across the batch
        self.lamx = np.empty((self.q, self.B, PROF.n_limbs), dtype=np.int32)
        for pi, (pid, shares) in enumerate(zip(party_ids, party_shares)):
            lam = hm.lagrange_coeff(quorum_xs, universe_xs[pid], hm.ED_L)
            self.lamx[pi] = scalars_to_limb_batch([lam * s.share % hm.ED_L for s in shares])
            for s in shares:
                if s.key_type != "ed25519":
                    raise ValueError("wrong key type")
                if s.participants != first.participants:
                    raise ValueError(
                        f"share for {pid!r} from a different participant "
                        f"universe — bucket sessions by topology"
                    )
                if s.threshold != first.threshold:
                    raise ValueError("mixed thresholds in one batch")
                if s.self_x != universe_xs[pid]:
                    raise ValueError(
                        f"share self_x {s.self_x} does not belong to "
                        f"{pid!r} (expected {universe_xs[pid]}) — "
                        f"party_shares misaligned with party_ids"
                    )
        self.A_comp = np.stack(
            [np.frombuffer(s.public_key, dtype=np.uint8) for s in party_shares[0]]
        )

    @torch.inference_mode()
    def sign(
        self, messages: Sequence[bytes], cohorts: Optional[int] = None,
        phase_times: Optional[dict] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Run the 3-round protocol for B sessions → ((B, 64) signatures,
        (B,) ok mask). Raises on commitment fraud.

        The batch runs as K counter-phase cohorts (engine/pipeline;
        ``cohorts=`` overrides MPCIUM_PIPELINE_COHORTS). All nonce and
        blind bytes are drawn for the full batch, in the K=1 order,
        before the split, so signatures are bit-identical for every K.
        Under an armed session mesh each cohort's slice is split again
        over the mesh (:func:`to_dev`), and its pieces run the round steps
        on their own devices. Equal-length messages hash their challenges
        on the device; a ragged batch hashes them on the host.
        With tracing on, each cohort records its rounds as ``phase:*``
        spans (tid ``eddsa:B<B>``, or ``…:c<i>`` for cohort i of several),
        synchronizing its devices at each mark. ``phase_times``: optional
        dict that receives wall seconds per phase the same way (each
        cohort's own rounds, cohorts added)."""
        assert len(messages) == self.B
        q, B, dev = self.q, self.B, self.device

        # all secret randomness precedes the cohort and mesh splits
        r64 = np.stack([fresh_nonce_bytes(B, self.rng) for _ in range(q)])
        blinds = np.stack([
            np.frombuffer(self.rng.token_bytes(B * 32), dtype=np.uint8).reshape(B, 32)
            for _ in range(q)
        ])

        plan = pl.CohortPlan.for_batch(B, cohorts)
        lens = {len(m) for m in messages}
        Mrows = None
        if len(lens) == 1:
            Mrows = np.frombuffer(b"".join(messages), np.uint8).reshape(B, lens.pop())
        prefs: dict = {}

        def pref(d: torch.device) -> torch.Tensor:
            if d not in prefs:
                prefs[d] = hs.as_bytes(COMMIT_PREFIX, d)
            return prefs[d]

        cohort_phases = [{} if phase_times is not None else None for _ in range(plan.k)]

        def job(ci: int, sl: slice):
            def run():
                pt = tracing.PhaseTimer(
                    "eddsa.sign", tracing.sync_tensors, phase_times=cohort_phases[ci],
                    node="engine", tid=f"eddsa:B{B}" if plan.serial else f"eddsa:B{B}:c{ci}",
                )
                sts = [round_step_nonce({"r64": r, "blinds": b}, pref(r.device))
                       for r, b in zip(to_dev(r64[:, sl], axis=1, device=dev),
                                       to_dev(blinds[:, sl], axis=1, device=dev),
                                       strict=True)]
                pt.mark("r1_nonce_commit", [st["commits"] for st in sts])
                sts = [round_step_aggregate(st) for st in sts]
                pt.mark("r2_decommit_aggregate", [st["R_sum"] for st in sts])
                ff = [st["fraud_free"] for st in sts]
                if not (yield ("fraud_verdict", lambda: all(bool(f) for f in ff))):  # mpcflow: host-ok — commitment-fraud verdict egress (one bool per device)
                    raise RuntimeError("commitment fraud detected")
                pt.restart()
                A_c = to_dev(self.A_comp[sl], device=dev)
                if Mrows is not None:
                    c64 = [challenge_device(st["R_sum"], a, m) for st, a, m in
                           zip(sts, A_c, to_dev(Mrows[sl], device=dev), strict=True)]
                else:
                    c64 = to_dev(challenge_hashes_host(
                        gather_host([st["R_sum"] for st in sts]), self.A_comp[sl],  # mpcflow: host-ok — ragged-message fallback: per-row hashlib reads host bytes; the equal-length default stays on device
                        messages[sl]), device=dev)
                sts = [round_step_partial(st, c, lx) for st, c, lx in zip(
                    sts, c64, to_dev(self.lamx[:, sl], axis=1, device=dev), strict=True)]
                pt.mark("r3_challenge_partials_combine", [st["sigs"] for st in sts])
                # local verification before publishing
                ok = [verify_signatures(st["sigs"], a, c) & st["ok_R"]
                      for st, a, c in zip(sts, A_c, c64, strict=True)]
                pt.mark("verify", ok)
                sigs = [st["sigs"] for st in sts]
                return (yield ("sig_egress", lambda: (gather_host(sigs), gather_host(ok))))  # mpcflow: host-ok — signature egress: final (R,s) + verdicts leave device for callers

            return run

        parts = pl.run_counter_phase([job(ci, sl) for ci, sl in enumerate(plan.slices())])
        tracing.add_phase_times(phase_times, cohort_phases)
        return (pl.merge_rows([p[0] for p in parts]), pl.merge_rows([p[1] for p in parts]))


def dealer_keygen_batch(
    n_wallets: int,
    party_ids: Sequence[str],
    threshold: int,
    rng=secrets,
):
    """Trusted-dealer batch keygen for tests and benchmarks only (wallets
    in production come from the DKG protocol). Returns per-party lists
    of KeygenShare: result[i] belongs to party_ids[i], wallet order
    aligned across parties. Draws per wallet, as the JAX package does:
    the secret, then the Shamir coefficients."""
    from ..protocol.base import KeygenShare, party_xs

    xs = party_xs(party_ids)
    out = [[] for _ in party_ids]
    for _ in range(n_wallets):
        secret = rng.randbelow(hm.ED_L - 1) + 1
        _, shares = hm.shamir_share(
            secret, threshold, [xs[p] for p in party_ids], hm.ED_L, rng=rng
        )
        pub = hm.ed_compress(hm.ed_mul(secret, hm.ED_B))
        for i, pid in enumerate(party_ids):
            out[i].append(
                KeygenShare(
                    key_type="ed25519",
                    share=shares[xs[pid]],
                    self_x=xs[pid],
                    public_key=pub,
                    participants=sorted(party_ids),
                    threshold=threshold,
                )
            )
    return out
