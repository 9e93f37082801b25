"""Multi-device execution of the batched signing step (PyTorch).

The port of ``mpcium_tpu/engine/sharded.py``. Two mesh axes map the
framework's two parallelism dimensions: ``committee`` — the n MPC
parties — and ``sessions`` — the concurrent-wallet batch. JAX builds a
``jax.sharding.Mesh`` and lets ``shard_map`` / GSPMD partition each
dispatch; torch has neither, so a :class:`SessionMesh` is an explicit
(committee, sessions) grid of ``torch.device``s and every function here
splits its batch tensors by hand, runs each piece on its own device and
gathers where JAX's ``all_gather`` does. As in the JAX package one node
process owns all its local devices; no rendezvous, no process group.
Entries may repeat (``["cuda:0"] * 4``): the work is then really split
and gathered, on one card.

The full signing step is two device phases with one host hash between
(the RFC 8032 challenge is SHA-512, control-plane):

  phase A  nonce commit:  r64 → r, R_i;  gather(R) → R = Σ R_i
  (host)   c = SHA512(R ‖ A ‖ M) per session
  phase B  partials s_i = r + c·λ·x;  gather(s_i) → s = Σ s_i;
           batched verify s·B == R + c·A

A committee gather collects the rows' pieces on the first device of
their session column, where the aggregation (``aggregate_nonce``,
``combine_signatures``) then runs. JAX caches one jitted function per
mesh; here nothing is compiled, so nothing is cached.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import bignum as bn
from ..core import secp256k1 as sp
from ..device import resolve
from . import eddsa_batch as eb

COMMITTEE = "committee"
SESSIONS = "sessions"

DevicesLike = Optional[Sequence[Union[str, torch.device]]]


@dataclass(frozen=True)
class SessionMesh:
    """A (committee, sessions) grid of devices: ``devices[i][j]`` computes
    committee block i of session block j."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def session_devices(self) -> Tuple[torch.device, ...]:
        """The sessions axis: the devices a session-sharded tensor lives on
        (replicated over the committee axis, so the first row's)."""
        return self.devices[0]

    @property
    def device_set(self) -> Tuple[torch.device, ...]:
        """Each distinct device once, in grid order."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))

    def describe(self) -> Dict[str, object]:
        return {"axes": [COMMITTEE, SESSIONS], "shape": list(self.shape),
                "devices": [[str(d) for d in row] for row in self.devices]}


def _local_devices(devices: DevicesLike) -> List[torch.device]:
    """None: every local CUDA device (raising without a GPU, as
    ``device.resolve`` does); else the given devices, repeats allowed, a
    CUDA device that is not present refused."""
    if devices is None:
        resolve(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    for d in out:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"asked for {d}, only {torch.cuda.device_count()} CUDA "
                             f"devices available — refusing to silently degrade the "
                             f"multi-device path")
    return out


def make_mesh(devices: DevicesLike = None, committee: Optional[int] = None) -> SessionMesh:
    """Mesh over (committee, sessions). The committee axis defaults to 2
    when it divides an even device count (parties on distinct device
    rows), else 1 (committee unsharded; sessions take every device)."""
    devs = _local_devices(devices)
    n = len(devs)
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    q_axis = committee if committee is not None else (2 if n % 2 == 0 else 1)
    if q_axis < 1 or n % q_axis:
        raise ValueError(f"committee axis {q_axis} must divide {n} devices")
    s_axis = n // q_axis
    return SessionMesh(tuple(tuple(devs[i * s_axis:(i + 1) * s_axis]) for i in range(q_axis)))


def arm_session_axis(devices: DevicesLike = None) -> Optional[SessionMesh]:
    """Production wiring of the session axis: with more than one local
    device, arm a committee-1 mesh over all of them, so every batch tensor
    entering the EdDSA engine (``eddsa_batch.to_dev``) is split over them
    and each party-round runs on every device. Returns the mesh, or None
    with one device (and disarms). The daemon calls this at startup."""
    devs = _local_devices(devices)
    if len(devs) <= 1:
        eb.arm_session_sharding(None)
        return None
    mesh = make_mesh(devs, committee=1)
    eb.arm_session_sharding(mesh)
    return mesh


def _blocks(n: int, parts: int, what: str) -> List[slice]:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split over a mesh axis of {parts}")
    w = n // parts
    return [slice(i * w, (i + 1) * w) for i in range(parts)]


# grid of per-device pieces: pieces[i][j] on mesh.devices[i][j]
Grid = List[List[torch.Tensor]]


def _grid(mesh: SessionMesh, x) -> Grid:
    """A (q, B, …) host array split over (committee, sessions)."""
    qa, sa = mesh.shape
    rows, cols = _blocks(x.shape[0], qa, COMMITTEE), _blocks(x.shape[1], sa, SESSIONS)
    return [[torch.as_tensor(np.array(x[ri, cj]), device=mesh.devices[i][j])
             for j, cj in enumerate(cols)] for i, ri in enumerate(rows)]


def _column(mesh: SessionMesh, x, j: int) -> torch.Tensor:
    """Session block j of a (B, …) host array, on its column's first device."""
    cj = _blocks(x.shape[0], mesh.shape[1], SESSIONS)[j]
    return torch.as_tensor(np.array(x[cj]), device=mesh.devices[0][j])


def _gather_committee(mesh: SessionMesh, pieces: Grid, j: int) -> torch.Tensor:
    """JAX's ``all_gather`` over the committee for session block j: every
    row's piece onto the column's first device, stacked in party order."""
    dev = mesh.devices[0][j]
    return torch.cat([pieces[i][j].to(dev) for i in range(mesh.shape[0])], dim=0)


@torch.inference_mode()
def commit_phase(mesh: SessionMesh, r64) -> Tuple[Grid, List[torch.Tensor], List[torch.Tensor]]:
    """Phase A over the mesh: (q, B, 64) nonce bytes → (nonce scalars as
    a grid of (q_loc, B_loc, 22) pieces, compressed R = Σ R_i per session
    block (B_loc, 32), the R-valid mask per session block)."""
    out = [[eb.nonce_commitments(p) for p in row] for row in _grid(mesh, r64)]
    r = [[o[0] for o in row] for row in out]
    R_comp = [[o[1] for o in row] for row in out]
    R_sum, ok = [], []
    for j in range(mesh.shape[1]):
        s, k = eb.aggregate_nonce(_gather_committee(mesh, R_comp, j))
        R_sum.append(s)
        ok.append(k)
    return r, R_sum, ok


@torch.inference_mode()
def sign_phase(mesh: SessionMesh, r: Grid, c64, lamx, R_sum: Sequence[torch.Tensor],
               A_comp) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Phase B over the mesh: nonce scalars + (B, 64) challenge hashes +
    (q, B, 22) λ·x limbs → ((B_loc, 64) signatures, (B_loc,) verified
    mask) per session block. The signature combine gathers the partials
    over the committee (a modular sum is not a psum: it reduces in the
    scalar ring)."""
    lam = _grid(mesh, lamx)
    parts = [[None] * mesh.shape[1] for _ in range(mesh.shape[0])]
    for i, row in enumerate(r):
        for j, r_ij in enumerate(row):
            c_ij = _column(mesh, c64, j).to(r_ij.device)
            parts[i][j] = eb.partial_signature(r_ij, c_ij.expand((r_ij.shape[0],) + c_ij.shape),
                                               lam[i][j])
    sigs, ok = [], []
    for j in range(mesh.shape[1]):
        sig, _ = eb.combine_signatures(_gather_committee(mesh, parts, j), R_sum[j])
        sigs.append(sig)
        ok.append(eb.verify_signatures(sig, _column(mesh, A_comp, j), _column(mesh, c64, j)))
    return sigs, ok


def sharded_sign(mesh: SessionMesh, r64: np.ndarray, lamx: np.ndarray, A_comp: np.ndarray,
                 messages: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """The full two-phase signing step over the mesh, with the host
    SHA-512 between → ((B, 64) signatures, (B,) ok mask) on the host."""
    r, R_sum, ok_R = commit_phase(mesh, r64)
    R_h = eb.gather_host(R_sum)  # mpcflow: host-ok — R enters the host challenge hash
    c64 = eb.challenge_hashes_host(R_h, A_comp, messages)
    sigs, ok = sign_phase(mesh, r, c64, lamx, R_sum, A_comp)
    return eb.gather_host(sigs), eb.gather_host(ok) & eb.gather_host(ok_R)  # mpcflow: host-ok — signature egress: final (R,s) + verdicts leave device for callers


# ---------------------------------------------------------------------------
# GG18: the session axis over the mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SessionShard:
    """One session block of a GG18 signer's per-wallet state, on its
    device: ``w`` and ``W_pts`` per party, ``Y`` the wallets' keys."""

    device: torch.device
    sl: slice
    w: Tuple[torch.Tensor, ...]
    W_pts: Tuple[object, ...]
    Y: object


def _put_pt(pt, sl: slice, dev: torch.device):
    return type(pt)(*(leaf[sl].to(dev) for leaf in pt))


def shard_gg18_sessions(signer, mesh: SessionMesh) -> List[SessionShard]:
    """Split a ``GG18BatchCoSigners``' per-wallet state (``w``, ``W_pts``,
    ``Y``) over the mesh's sessions axis: one :class:`SessionShard` per
    session device, stored as ``signer.session_shards`` and returned.
    Every GG18 block is batch-parallel, so a shard needs no collective.

    The COMMITTEE axis is deliberately not used, as in the JAX package:
    each party's Paillier / ring-Pedersen moduli belong to its trust
    domain, so parties are separate programs exchanging round tensors."""
    shards = [
        SessionShard(dev, sl, tuple(w[sl].to(dev) for w in signer.w),
                     tuple(_put_pt(p, sl, dev) for p in signer.W_pts),
                     _put_pt(signer.Y, sl, dev))
        for dev, sl in zip(mesh.session_devices,
                           _blocks(signer.B, mesh.shape[1], SESSIONS))
    ]
    signer.session_shards = shards
    return shards


@torch.inference_mode()
def gg18_curve_leg(signer, digests: np.ndarray) -> Dict[str, np.ndarray]:
    """The GG18 signing algebra of the JAX dry run's multi-device leg
    (``__graft_entry__.dryrun_multichip``) over the signer's session
    shards (``shard_gg18_sessions``; without them, the whole batch on
    ``signer.device``): Γ_i = γ_i·G with hash commitments and their
    checks, R = δ⁻¹·ΣΓ_i, r, and s = Σ (m·k_i + r·σ_i), low-s, where
    the MtA products δ = k·γ and σ = k·w are formed in the ring (one
    process holds every party's share). k, γ and the blinds are drawn
    from ``signer.rng`` for the whole batch, in the JAX order, before the
    split. → {"r", "s": (B, 32) big-endian bytes, "ok": (B,) bool}."""
    from . import gg18_batch as gb

    q, B = signer.q, signer.B
    k_raw = gb.rand_bits(q * B, 320, signer.rng).reshape(q, B, 40)
    g_raw = gb.rand_bits(q * B, 320, signer.rng).reshape(q, B, 40)
    b_raw = gb.rand_bits(q * B, 256, signer.rng).reshape(q, B, 32)
    shards = getattr(signer, "session_shards", None) or [
        SessionShard(signer.device, slice(0, B), tuple(signer.w), tuple(signer.W_pts), signer.Y)]
    half = bn.to_limbs(gb.Q // 2, bn.P256)
    out = []
    for sh in shards:
        dev, sl = sh.device, sh.sl
        ring = sp.scalar_ring(dev)
        Bs = sl.stop - sl.start

        def scalars(raw):
            return gb._scalar_from_wide_bytes(torch.as_tensor(raw[:, sl].copy(), device=dev))

        k, gamma = scalars(k_raw), scalars(g_raw)
        blind = torch.as_tensor(b_raw[:, sl].copy(), device=dev)
        m = ring.reduce(bn.bytes_to_limbs_le(
            torch.as_tensor(digests[sl, ::-1].copy(), device=dev), bn.P256, 22))
        idx = [gb._idx_row(i, Bs, dev) for i in range(q)]
        Gamma, comp, commit = zip(*(gb._blk_gamma(gamma[i], blind[i], idx[i]) for i in range(q)))
        k_sum, g_sum, w_sum, Gamma_sum = k[0], gamma[0], sh.w[0], Gamma[0]
        for i in range(1, q):
            k_sum = ring.addmod(k_sum, k[i])
            g_sum = ring.addmod(g_sum, gamma[i])
            w_sum = ring.addmod(w_sum, sh.w[i])
            Gamma_sum = sp.add(Gamma_sum, Gamma[i])
        ok = gb._blk_gamma_check(blind[0], comp[0], idx[0], commit[0])
        for i in range(1, q):
            ok = ok & gb._blk_gamma_check(blind[i], comp[i], idx[i], commit[i])
        # in-ring MtA products: δ = k·γ, σ = k·w, held by party 0
        delta = ring.mulmod(k_sum, g_sum)
        sigma = ring.mulmod(k_sum, w_sum)
        okR, _R_pt, r, _rec = gb._blk_R(delta, Gamma_sum)
        s = ring.addmod(ring.mulmod(m, k[0]), ring.mulmod(r, sigma))
        for i in range(1, q):
            s = ring.addmod(s, ring.mulmod(m, k[i]))
        high = bn.compare(s, torch.as_tensor(half, device=dev)) > 0
        s = torch.where(high[..., None], ring.negmod(s), s)
        out.append((bn.limbs_to_bytes_le(r, bn.P256, 32), bn.limbs_to_bytes_le(s, bn.P256, 32),
                    okR & ok))
    return {"r": eb.gather_host([o[0] for o in out])[:, ::-1].copy(),
            "s": eb.gather_host([o[1] for o in out])[:, ::-1].copy(),
            "ok": eb.gather_host([o[2] for o in out])}


# ---------------------------------------------------------------------------
# K0 over the mesh: the MtA's modular products
# ---------------------------------------------------------------------------


@torch.inference_mode()
def sharded_mulmod(mesh: SessionMesh, modulus: int, a, b) -> np.ndarray:
    """a·b mod ``modulus`` over (B, n) 7-bit limb rows split along the
    sessions axis: each session device's block through K0 (its plain
    version on the CPU), joined in session order on the host — the
    counterpart of the dry run's sharded ``MXUBarrett.mulmod``. One
    Barrett context per distinct device (its constants and K0's word
    arrays live there); one K0 launch per session device."""
    from ..ops.modmul import MXUBarrett

    ctx = {d: MXUBarrett(modulus, device=d) for d in mesh.device_set}
    devs = mesh.session_devices
    out = [ctx[d].mulmod(torch.as_tensor(np.array(a[sl]), device=d),
                         torch.as_tensor(np.array(b[sl]), device=d))
           for d, sl in zip(devs, _blocks(a.shape[0], len(devs), SESSIONS))]
    return eb.gather_host(out)
