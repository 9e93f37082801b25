"""OT-based MtA: Gilboa multiplication over the secp256k1 scalar ring.

The port of ``mpcium_tpu/protocol/ecdsa/mta_ot.py``. Alice holds ``a``,
Bob holds ``b``, and they derive additive shares of ``a·b mod q`` from
256 1-of-2 OTs per product: Chou–Orlandi base OTs once per ordered pair
(Bob, the MtA sender, is the base-OT receiver with choice bits Δ), IKNP
extension per signing batch under a per-(leg, invocation) counter, and
payloads ``z`` / ``z + 2^i·b mod q`` that Alice selects by bit i of
``a``. Alice's share is the sum of what she received, Bob's ``-Σz``.

Active checks (on by default, ``MPCIUM_OT_CHECKS=0`` turns them off and
must then be off quorum-wide): a KOS correlation check (verifier Bob,
blames Alice), the Gilboa ψ-encoding check and the MtA output
consistency check (verifier Alice, blame Bob). Verdicts land per lane in
``check_verdicts``; ``check_blame`` turns them into an identifiable
abort.

Everything the extension and the checks compute stays on the leg's
device: SHA-256 PRG expansion, pads and Merkle digests ride
:mod:`ops.hash_suite`, the KOS GF(2) sums are float64 batched matmuls
of 0/1 matrices (exact: every sum is at most 256) masked to the low
bit, the mod-q sums ride the scalar ring and the curve checks the
batched secp256k1 ladders. The host sees the z bytes (uploaded once per
payload set), the check verdicts, the wire messages of the three-round
composition and, when asked, the ``transcript`` capture. Wire bytes,
shares and verdicts are the JAX package's byte for byte
(``OT_WIRE_VERSION`` 3).

``run_multi`` has a second route, the host pipelined extension, taken
under ``MPCIUM_OT_DEVICE=0`` or for more than ``MAX_PAYLOAD_SETS``
payload sets: the payload math is queued on the device for every chunk,
one ``ot-host`` worker thread runs each chunk's PRG expansion, transpose
and pad hashing through the C++ :mod:`mpcium_tpu_torch.native` library
(which drops the GIL), and the main thread masks and selects as the
chunks arrive. The checks run on the device on either route, and the
bytes are the same.
"""
from __future__ import annotations

import functools
import hashlib
import os
import secrets as _secrets
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import native
from ...core import bignum as bn
from ...core import hostmath as hm
from ...core import secp256k1 as sp
from ...core.bignum import P256
from ...core.fields import secp256k1_field
from ...device import resolve
from ...engine.graphs import no_capture
from ...ops import hash_suite as hs
from ...utils import tracing

KAPPA = 128  # IKNP width / computational security parameter
NBITS = 256  # multiplicand bits (secp256k1 scalars)
Q = hm.SECP_N
OT_WIRE_VERSION = 3  # wire/domain version: rides every PRF/pad tag

CHECK_KOS = "kos"                  # verifier Bob; failure blames Alice
CHECK_GILBOA = "gilboa"            # verifier Alice; failure blames Bob
CHECK_CONSISTENCY = "consistency"  # verifier Alice; failure blames Bob

MAX_PAYLOAD_SETS = 10  # `|s10` would widen the pad prefix by one byte

# The host route's double buffer is one worker: run_multi queues every
# chunk's host stage on it in order, and the main thread drains the
# chunks while the worker expands the next (the native calls drop the
# GIL, so the two overlap).
_HOST_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _host_pool() -> ThreadPoolExecutor:
    global _HOST_POOL
    with _POOL_LOCK:
        if _HOST_POOL is None:
            _HOST_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ot-host")
        return _HOST_POOL


def resolve_chunks(B: int, chunks: Optional[int] = None) -> int:
    """Extension chunk count: explicit argument wins, then
    MPCIUM_OT_CHUNKS, then auto from the batch (B // 256, 1 to 8).
    Clamped to the largest divisor of B so every chunk has one shape.
    Chunking never changes a byte of the transcript."""
    if chunks is None or chunks <= 0:
        chunks = int(os.environ.get("MPCIUM_OT_CHUNKS", "0") or 0)
    if chunks <= 0:
        chunks = max(1, min(8, B // 256))
    chunks = max(1, min(chunks, B))
    while B % chunks:
        chunks -= 1
    return chunks


def device_path_enabled() -> bool:
    """MPCIUM_OT_DEVICE (read per call, default on) selects
    ``run_multi``'s device extension; ``0`` selects the host pipelined
    one. Both give the same bytes."""
    return os.environ.get("MPCIUM_OT_DEVICE", "1") != "0"


def ot_checks_enabled() -> bool:
    """MPCIUM_OT_CHECKS gates the active-security checks (default on).
    It must be set alike quorum-wide: a checking party rejects an
    unchecked peer's round messages loudly."""
    return os.environ.get("MPCIUM_OT_CHECKS", "1") != "0"


# ---------------------------------------------------------------------------
# base OTs (Chou–Orlandi on secp256k1, once per ordered pair)
# ---------------------------------------------------------------------------


def _pt_hash_rows(comp_rows: np.ndarray) -> np.ndarray:
    """(n, 33) compressed points → (n, 32) key rows
    sha256("mpcium-ot-base|" ‖ point) (κ rows once per leg: host)."""
    out = np.empty((comp_rows.shape[0], 32), np.uint8)
    for i, r in enumerate(comp_rows):
        out[i] = np.frombuffer(
            hashlib.sha256(b"mpcium-ot-base|" + r.tobytes()).digest(), np.uint8
        )
    return out


def _secp_neg(pt: hm.SecpPoint) -> hm.SecpPoint:
    if pt.is_infinity:
        return pt
    return hm.SecpPoint(pt.x, (-pt.y) % hm.SECP_P)


def _bcast_pt(pt_bytes: bytes, n: int, device) -> sp.SecpPointJ:
    """Compressed point → device point broadcast to batch n."""
    p = sp.from_host([hm.secp_decompress(pt_bytes)], device)
    return sp.SecpPointJ(*(c.expand(n, c.shape[-1]) for c in p))


def base_ot_sender_init(rng=_secrets) -> Tuple[int, bytes]:
    """Alice (MtA receiver = base-OT sender): y, S = y·G."""
    y = rng.randbelow(Q - 1) + 1
    return y, hm.secp_compress(hm.secp_mul(y, hm.SECP_G))


def base_ot_receive(
    S_bytes: bytes, rng=_secrets, device=None
) -> Tuple[np.ndarray, np.ndarray, List[bytes]]:
    """Bob: picks Δ ∈ {0,1}^κ; per base OT j sends R_j = x_j·G + Δ_j·S
    and keeps k^{Δ_j}_j = H(x_j·S). → (delta_bits, keys, R_msgs). The κ
    ladders run as one batch on ``device``."""
    device = resolve(device)
    delta = np.frombuffer(rng.token_bytes(KAPPA), np.uint8) & 1
    xs = [rng.randbelow(Q - 1) + 1 for _ in range(KAPPA)]
    bits = torch.as_tensor(sp.scalars_to_bits(xs), device=device)
    S_pt = _bcast_pt(S_bytes, KAPPA, device)
    XG = sp.base_mul(bits)
    R = sp.select(torch.as_tensor(delta, device=device).bool(), sp.add(XG, S_pt), XG)
    msgs = [bytes(r) for r in sp.compress(R).cpu().numpy()]  # mpcflow: host-ok — base-OT wire messages (κ=128 rows, once per pair)
    keys = _pt_hash_rows(sp.compress(sp.scalar_mul(bits, S_pt)).cpu().numpy())  # mpcflow: host-ok — ROT key derivation hashes on host (κ=128 rows, once per pair)
    return delta, keys, msgs


def base_ot_sender_keys(
    y: int, R_msgs: Sequence[bytes], device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Alice: k0_j = H(y·R_j), k1_j = H(y·(R_j − S)) = H(y·R_j − y·S)."""
    device = resolve(device)
    S = hm.secp_mul(y, hm.SECP_G)
    yS_neg = _secp_neg(hm.secp_mul(y, S))
    R = sp.from_host([hm.secp_decompress(rb) for rb in R_msgs], device)
    y_bits = torch.as_tensor(sp.scalars_to_bits([y]), device=device).expand(KAPPA, NBITS)
    yR = sp.scalar_mul(y_bits, R)
    yRmS = sp.add(yR, _bcast_pt(hm.secp_compress(yS_neg), KAPPA, device))
    return (
        _pt_hash_rows(sp.compress(yR).cpu().numpy()),  # mpcflow: host-ok — ROT key derivation hashes on host (κ=128 rows, once per pair)
        _pt_hash_rows(sp.compress(yRmS).cpu().numpy()),  # mpcflow: host-ok — ROT key derivation hashes on host (κ=128 rows, once per pair)
    )


# ---------------------------------------------------------------------------
# scalar-ring helpers (batched mod-q arithmetic on 12-bit limbs)
# ---------------------------------------------------------------------------


def _ring(t: torch.Tensor) -> bn.BarrettCtx:
    return sp.scalar_ring(t.device)


@functools.lru_cache(maxsize=None)
def _pow2_limbs(device) -> torch.Tensor:
    """(NBITS, 22) limbs of 2^i mod q."""
    vals = [pow(2, i, Q) for i in range(NBITS)]
    return torch.as_tensor(bn.batch_to_limbs(vals, P256), device=device)


def _pow2_ladder(b: torch.Tensor) -> torch.Tensor:
    """(B, n) scalars mod q → (NBITS, B, n) with ladder[i] = 2^i·b mod q
    (one batched product by the 2^i table; the JAX package doubles 256
    times — same canonical residues)."""
    return _ring(b).mulmod(b[None], _pow2_limbs(b.device)[:, None, :])


def _m1_payloads(z_red: torch.Tensor, pow2b: torch.Tensor) -> torch.Tensor:
    """(B, NBITS, n) reduced z + (NBITS, B, n) ladder → m1 bytes
    (B, NBITS, 32)."""
    m1 = _ring(z_red).addmod(z_red, pow2b.movedim(0, 1))
    return bn.limbs_to_bytes_le(m1, P256, 32)


def _reduce_bytes(raw: torch.Tensor) -> torch.Tensor:
    """(..., 32) LE bytes → reduced (..., n) scalars mod q."""
    return _ring(raw).reduce(bn.bytes_to_limbs_le(raw, P256, 22))


def _sum_mod_q(vals: torch.Tensor) -> torch.Tensor:
    """(B, NBITS, n) reduced scalars → (B, n) sum mod q (limb sums stay
    below 2^21; carried, then Barrett-reduced)."""
    return _ring(vals).reduce(bn.carry(vals.sum(-2), P256))


def _neg_sum_mod_q(vals: torch.Tensor) -> torch.Tensor:
    return _ring(vals).negmod(_sum_mod_q(vals))


def _bits_256(a: torch.Tensor) -> torch.Tensor:
    """(B, n) scalars → (B, NBITS) int32 bits LSB-first."""
    return bn.limbs_to_bits(a, P256, NBITS)


def _pad_idx(m_off: int, M: int, device) -> torch.Tensor:
    """le32 OT indices [m_off, m_off + M) → (M, 4)."""
    return hs.le32_bytes(m_off + torch.arange(M, dtype=torch.int64, device=device))


def _prefix_rows(prefixes: Sequence[bytes], device) -> torch.Tensor:
    """Equal-length domain prefixes → (S, P) uint8."""
    return hs.as_bytes(
        np.frombuffer(b"".join(prefixes), np.uint8).reshape(len(prefixes), -1), device
    )


def _ot_chunk_device(
    st, prg_prefix, pad_prefixes, r_bits_c, r_packed_c, m0s, m1s, blk_off, m_off,
):
    """One chunk of the extension on the device: PRG-expand the three
    seed matrices, assemble U and Q, transpose both, derive every
    payload set's pads, mask the payloads and recover Alice's
    selections — byte for byte the three-round composition.

    Shapes (Bc lanes, Mc = Bc·NBITS OTs, S payload sets): st["seeds"]
    (3, κ, 32) = k0, k1, kD; pad_prefixes (S, P); r_bits_c (Mc,);
    r_packed_c (Mc/8,); m0s / m1s (S, Bc, NBITS, 32); blk_off / m_off
    the chunk's PRG block and OT index origins. → (alphas (S, Bc, n),
    U (κ, Bc·32), y0s, y1s (S, Mc, 32), rows_a, rows_b (Mc, κ/8),
    sels (S, Mc, 32))."""
    Bc = r_packed_c.shape[0] // 32
    Mc = r_bits_c.shape[0]
    S = pad_prefixes.shape[0]
    t0, t1, tD = hs.prg_expand_core(st["seeds"], prg_prefix, Bc, blk_off).unbind(0)
    U = t0 ^ t1 ^ r_packed_c[None, :]
    Qm = tD ^ (U & st["delta_mask"])  # fold U into the Δ=1 rows only
    rows_a = hs.ot_transpose_core(t0)  # (Mc, κ/8)
    rows_b = hs.ot_transpose_core(Qm)
    rows = torch.stack([rows_a, rows_b, rows_b ^ st["delta_packed"][None, :]])
    # every set's pads in one hash call: (S, 3, Mc, 32) = pad_a, pad0, pad1
    pads = hs.pad_hash_core(
        pad_prefixes[:, None, :], rows[None], _pad_idx(m_off, Mc, rows.device)
    )
    y0s = pads[:, 1] ^ m0s.reshape(S, Mc, 32)
    y1s = pads[:, 2] ^ m1s.reshape(S, Mc, 32)
    sels = torch.where(r_bits_c.bool()[None, :, None], y1s, y0s) ^ pads[:, 0]
    alphas = _sum_mod_q(_reduce_bytes(sels.reshape(S, Bc, NBITS, 32)))
    return alphas, U, y0s, y1s, rows_a, rows_b, sels


# ---------------------------------------------------------------------------
# active-security checks: KOS correlation, Gilboa ψ-encoding, MtA output
# consistency — batched SHA-256, GF(2) sums as exact matmuls, scalar-ring
# sums and curve ladders, all on the device
# ---------------------------------------------------------------------------


def _fs_prefixes(tag: bytes, kind: bytes, set_idx: Optional[int] = None,
                 device=None) -> Tuple[torch.Tensor, ...]:
    """Fiat–Shamir hash-domain prefixes (leaf / merkle-node / prg) for
    one check family."""
    base = b"mpcium-ot-" + kind + b"|" + tag
    if set_idx is not None:
        base += b"|s%d" % set_idx
    return tuple(hs.as_bytes(base + sfx, device) for sfx in (b"|leaf", b"|node", b"|prg"))


def _pt_encode(p: sp.SecpPointJ) -> torch.Tensor:
    """Batch points → SEC1 *uncompressed* bytes (..., 65) (the identity
    encodes as 04 ‖ 0^64, which decode rejects)."""
    F = secp256k1_field(p.X.device)
    zi = F.inv(p.Z)
    x = F.canonical(F.mul(p.X, zi))
    y = F.canonical(F.mul(p.Y, zi))
    tag = torch.full(x.shape[:-1] + (1,), 4, dtype=torch.uint8, device=x.device)
    return torch.cat([tag, sp.pack_be_32(x), sp.pack_be_32(y)], dim=-1)


def _pt_decode(b: torch.Tensor) -> Tuple[sp.SecpPointJ, torch.Tensor]:
    """SEC1 uncompressed (..., 65) → (point, ok mask). Bad encodings
    (wrong tag, coordinates ≥ p, off the curve) give ok=False with a
    valid-shape point; callers fold the mask into the verdict."""
    F = secp256k1_field(b.device)
    tag = b[..., 0].to(torch.int64)
    x = bn.bytes_to_limbs_le(torch.flip(b[..., 1:33], dims=(-1,)), sp.PROF, sp.PROF.n_limbs)
    y = bn.bytes_to_limbs_le(torch.flip(b[..., 33:65], dims=(-1,)), sp.PROF, sp.PROF.n_limbs)
    p_l = torch.as_tensor(bn.to_limbs(hm.SECP_P, sp.PROF), device=b.device)
    on_curve = F.eq(F.square(y), F.add(F.mul(F.square(x), x), F.const(7, x.shape[:-1])))
    ok = (tag == 4) & (bn.compare(x, p_l) < 0) & (bn.compare(y, p_l) < 0) & on_curve
    one = F.const(1, x.shape[:-1])
    return sp.SecpPointJ(F.from_limbs(x), F.from_limbs(y), one), ok


def _merkle_root(leaves: torch.Tensor, node_prefix: torch.Tensor) -> torch.Tensor:
    """(..., L, 32) digests, L a power of two → (..., 32) Merkle root,
    one batched pair-hash per level."""
    P = node_prefix.shape[0]
    while leaves.shape[-2] > 1:
        half = leaves.shape[-2] // 2
        pairs = leaves.reshape(leaves.shape[:-2] + (half, 64))
        msg = torch.cat([node_prefix.expand(pairs.shape[:-1] + (P,)), pairs], dim=-1)
        leaves = hs.sha256_core(msg, P + 64)
    return leaves[..., 0, :]


def _gf2_matmul(chi: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Batched GF(2) product (B, r, j) · (B, j, c) of 0/1 matrices → (B, r,
    c) int64 0/1: a float64 matmul (every sum ≤ 256, exact; no TF32 on
    the path) masked to the low bit."""
    prod = torch.matmul(chi.to(torch.float64), bits.to(torch.float64))
    return prod.to(torch.int64) & 1


def _chi_bits(U: torch.Tensor, leaf_p, node_p, prg_p) -> torch.Tensor:
    """Per-lane KOS challenge χ ∈ GF(2)^{κ×256}, Fiat–Shamir-derived from
    the lane's own U columns: leaf digests per row → Merkle root → PRG.
    U (κ, B·32) packed → (B, κ, 256) uint8 0/1."""
    Bn = U.shape[1] // 32
    lanes = U.reshape(KAPPA, Bn, 32).movedim(1, 0)  # (B, κ, 32)
    r_le = hs.le16_bytes(torch.arange(KAPPA, dtype=torch.int64, device=U.device))
    P = leaf_p.shape[0]
    msg = torch.cat(
        [leaf_p.expand(Bn, KAPPA, P), lanes, r_le.expand(Bn, KAPPA, 2)], dim=-1
    )
    root = _merkle_root(hs.sha256_core(msg, P + 34), node_p)  # (B, 32)
    raw = hs.prg_expand_core(root, prg_p, KAPPA, 0)  # seed j = lane j
    return hs.unpack_bits_core(raw.reshape(Bn, KAPPA, 32))


def _k_kos_tags(rows_a, x_bits, U, leaf_p, node_p, prg_p):
    """Alice's KOS opening x̄ = χ·x, t̄ = χ·T over GF(2). rows_a (M, κ/8)
    packed, x_bits (M,) 0/1, U (κ, B·32) → (x̄ packed (B, κ/8), t̄
    packed (B, κ, κ/8))."""
    Bn = x_bits.shape[0] // NBITS
    chi = _chi_bits(U, leaf_p, node_p, prg_p)  # (B, κ, 256)
    xbar = _gf2_matmul(chi, x_bits.reshape(Bn, NBITS, 1))[..., 0]
    bits_a = hs.unpack_bits_core(rows_a).reshape(Bn, NBITS, KAPPA)
    tbar = _gf2_matmul(chi, bits_a)
    return hs.pack_bits_core(xbar), hs.pack_bits_core(tbar)


def _k_kos_verify(rows_b, delta_bits, U, xbar_p, tbar_p, leaf_p, node_p, prg_p):
    """Bob's side: χ·Q == t̄ ⊕ x̄ ⊗ Δ per lane → (B,) bool."""
    Bn = rows_b.shape[0] // NBITS
    chi = _chi_bits(U, leaf_p, node_p, prg_p)
    qbar = _gf2_matmul(chi, hs.unpack_bits_core(rows_b).reshape(Bn, NBITS, KAPPA))
    xbar = hs.unpack_bits_core(xbar_p).to(torch.int64)  # (B, κ)
    tbar = hs.unpack_bits_core(tbar_p).to(torch.int64)  # (B, κ, κ)
    want = tbar ^ (xbar[..., None] * delta_bits.to(torch.int64)[None, None, :])
    return torch.all((qbar == want).flatten(-2), dim=-1)


def _psi_weights(y0, y1, leaf_p, node_p, prg_p) -> torch.Tensor:
    """Per-lane Gilboa weights ψ_i ∈ Z_q, derived from the MASKED payload
    rows: leaf digests of (y0_i ‖ y1_i ‖ le32(i)) → Merkle root → PRG →
    mod q. (M, 32) ×2 → (B, NBITS, n)."""
    M = y0.shape[0]
    Bn = M // NBITS
    P = leaf_p.shape[0]
    msg = torch.cat(
        [leaf_p.expand(M, P), y0, y1, _pad_idx(0, M, y0.device)], dim=-1
    )
    leaves = hs.sha256_core(msg, P + 68).reshape(Bn, NBITS, 32)
    root = _merkle_root(leaves, node_p)  # (B, 32)
    raw = hs.prg_expand_core(root, prg_p, NBITS, 0)  # seed j = lane j
    return _reduce_bytes(raw.reshape(Bn, NBITS, 32))


def _base_mul_pair(bits_a: torch.Tensor, bits_b: torch.Tensor):
    """(x·G, y·G) for two (B, NBITS) bit batches in one ladder."""
    pt = sp.base_mul(torch.cat([bits_a, bits_b]))
    n = bits_a.shape[0]
    return (sp.SecpPointJ(*(c[:n] for c in pt)), sp.SecpPointJ(*(c[n:] for c in pt)))


def _k_gilboa_bob(y0, y1, z_red, b_scalars, leaf_p, node_p, prg_p, psi=None):
    """Bob's opening for one payload set: D = Σψ_i·z_i mod q and the
    curve commitments B = b·G, β·G (β = −Σz) → (D LE bytes (B, 32),
    uncompressed B_pt (B, 65), Beta_pt (B, 65))."""
    if psi is None:
        psi = _psi_weights(y0, y1, leaf_p, node_p, prg_p)
    D = _sum_mod_q(_ring(psi).mulmod(psi, z_red))
    enc = _pt_encode(sp.base_mul(torch.cat([
        _bits_256(b_scalars), _bits_256(_neg_sum_mod_q(z_red))
    ])))
    n = b_scalars.shape[0]
    return bn.limbs_to_bytes_le(D, P256, 32), enc[:n], enc[n:]


def _k_gilboa_alice(y0, y1, msel, x_bits, D_bytes, B_comp, leaf_p, node_p, prg_p,
                    psi=None):
    """Alice's encoding check for one payload set:
    (Σψ_i·m_sel,i)·G == D·G + (Σ_{x_i=1} ψ_i·2^i)·B. msel: the UNMASKED
    selections (B, NBITS, 32); a non-decodable B_pt fails. → (B,) bool."""
    if psi is None:
        psi = _psi_weights(y0, y1, leaf_p, node_p, prg_p)
    ring = _ring(psi)
    Bn = msel.shape[0]
    A_psi = _sum_mod_q(ring.mulmod(psi, _reduce_bytes(msel)))
    xb = x_bits.reshape(Bn, NBITS)
    psi_x = torch.where((xb != 0)[..., None], psi, torch.zeros_like(psi))
    c_x = _sum_mod_q(ring.mulmod(psi_x, _pow2_limbs(psi.device)))
    D = ring.reduce(bn.bytes_to_limbs_le(D_bytes, P256, 22))
    B_pt, okB = _pt_decode(B_comp)
    lhs, DG = _base_mul_pair(_bits_256(A_psi), _bits_256(D))
    rhs = sp.add(DG, sp.scalar_mul(_bits_256(c_x), B_pt))
    return sp.equal(rhs, lhs) & okB


def _k_consistency(alpha, x_bits, B_comp, Beta_comp):
    """MtA output consistency for one payload set: α·G + β·G == a·B, with
    a's bits = Alice's choice bits (LSB-first). → (B,) bool."""
    Bn = alpha.shape[0]
    B_pt, okB = _pt_decode(B_comp)
    beta_pt, okE = _pt_decode(Beta_comp)
    lhs = sp.base_mul(_bits_256(alpha))
    rhs = sp.scalar_mul(x_bits.reshape(Bn, NBITS), B_pt)
    return sp.equal(sp.add(lhs, beta_pt), rhs) & okB & okE


# ---------------------------------------------------------------------------
# tamper hook (tests / chaos drills)
# ---------------------------------------------------------------------------


def _tamper_lane_view(field: str, arr: np.ndarray, lane: int) -> np.ndarray:
    """The slice of a wire tensor one batch lane owns."""
    if field == "U":
        return arr[:, lane * 32:(lane + 1) * 32]
    if field in ("kos_xbar", "kos_tbar", "D", "B_pt", "Beta_pt"):
        return arr[lane]
    if field in ("y0", "y1"):
        return arr[lane * NBITS:(lane + 1) * NBITS]
    raise ValueError(f"unknown tamper field {field!r}")


def _apply_tamper(spec: Dict, msg: Dict) -> bool:
    """Flip one byte of one lane's slice of ``spec["field"]`` in a round
    message (False when the field is absent: the caller then targets
    the other round). Writes through a fresh copy."""
    field = spec["field"]
    if field not in msg:
        return False
    arr = np.array(msg[field])
    view = _tamper_lane_view(field, arr, int(spec.get("lane", 0)))
    idx = np.unravel_index(int(spec.get("byte", 0)) % view.size, view.shape)
    view[idx] = view[idx] ^ np.uint8(int(spec.get("xor", 1)) or 1)
    msg[field] = arr
    return True


def _pack(bits: np.ndarray) -> np.ndarray:
    """(..., n) 0/1 → packed little-endian-bit bytes (..., n/8)."""
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _prg_host(seeds: np.ndarray, tag: bytes, nblk: int, blk_off: int) -> np.ndarray:
    """The host route's keystream: (n, 32) seeds → (n, nblk·32), blocks
    [blk_off, blk_off + nblk) of each seed's stream."""
    return native.prg_expand(b"mpcium-ot-prg|" + tag, seeds, nblk, blk_off)


def _derive_pads_multi(prefixes, packed: np.ndarray, M: int, delta=None, m_off: int = 0):
    """Per-OT pads from the packed (κ, M/8) extension matrix, for several
    payload-set domains: pad_s[j] = H(prefix_s ‖ column j re-packed ‖
    le32(m_off + j)), plus the Δ-offset variant per set when ``delta``
    (packed κ/8) is given. The transpose runs once for every set.
    → [pad_s] or [(pad0_s, pad1_s)] in prefix order."""
    rows = native.ot_transpose(packed)
    idx = np.arange(m_off, m_off + M, dtype="<u4").view(np.uint8).reshape(M, 4)
    buf = np.concatenate([rows, idx], axis=1)
    if delta is None:
        return [native.batch_sha256(p, buf) for p in prefixes]
    bufd = np.concatenate([rows ^ delta[None, :], idx], axis=1)
    return [(native.batch_sha256(p, buf), native.batch_sha256(p, bufd)) for p in prefixes]


# ---------------------------------------------------------------------------
# the per-ordered-pair MtA instance
# ---------------------------------------------------------------------------


class OTMtALeg:
    """One ordered quorum pair (Alice = receiver with ``a``; Bob = sender
    with ``b``) on ``device`` (default: the GPU; raises when there is
    none). Both roles live on this object, but every inter-party value
    flows through explicit round messages. One instance serves every
    batch invocation (extension counter in all PRF/hash domains)."""

    def __init__(self, tag: str, rng=_secrets, device=None):
        self.device = resolve(device)
        self.tag = tag.encode()
        self.rng = rng
        self.ctr = 0
        y, S = base_ot_sender_init(rng)
        self.delta, self.keysD, R_msgs = base_ot_receive(S, rng, self.device)
        self.k0, self.k1 = base_ot_sender_keys(y, R_msgs, self.device)
        self._init_derived()

    @classmethod
    def from_base_ot(cls, tag, k0: np.ndarray, k1: np.ndarray, delta: np.ndarray,
                     rng=_secrets, device=None) -> "OTMtALeg":
        """A leg from given base-OT outputs (the base OTs' postcondition:
        Bob holds k^{Δ_j}_j). For tests and drills that need fixed keys."""
        leg = cls.__new__(cls)
        leg.device = resolve(device)
        leg.tag = tag.encode() if isinstance(tag, str) else bytes(tag)
        leg.rng = rng
        leg.ctr = 0
        leg.k0 = np.asarray(k0, np.uint8)
        leg.k1 = np.asarray(k1, np.uint8)
        leg.delta = np.asarray(delta, np.uint8) & 1
        leg.keysD = np.where(leg.delta[:, None].astype(bool), leg.k1, leg.k0)
        leg._init_derived()
        return leg

    def _init_derived(self) -> None:
        self.delta_packed = _pack(self.delta)  # (16,)
        self._delta_rows = np.nonzero(self.delta)[0]
        self._tamper = None
        self.check_verdicts = None
        self._dev_state = None

    def _ext_tag(self, ctr: int) -> bytes:
        """Per-invocation PRF/pad domain tag, version-stamped."""
        return self.tag + b"|v%d|%d" % (OT_WIRE_VERSION, ctr)

    @staticmethod
    def _pad_prefixes(tag: bytes, n_sets: int) -> List[bytes]:
        return [b"mpcium-ot-pad|" + tag + b"|s%d" % s for s in range(n_sets)]

    def _device_state(self) -> Dict[str, torch.Tensor]:
        """Base-OT key material on the device, uploaded once per leg."""
        if self._dev_state is None:
            dev = self.device
            self._dev_state = {
                "seeds": hs.as_bytes(np.stack([self.k0, self.k1, self.keysD]), dev),
                "delta_mask": hs.as_bytes((self.delta * np.uint8(0xFF))[:, None], dev),
                "delta_packed": hs.as_bytes(self.delta_packed, dev),
                "delta_bits": torch.as_tensor(self.delta.astype(np.int64), device=dev),
            }
        return self._dev_state

    def _prg(self, which: slice, tag: bytes, blk_off: int, Bc: int) -> torch.Tensor:
        """Keystreams of seed matrices ``which`` (of k0, k1, kD) for lanes
        [blk_off, blk_off + Bc) → (·, κ, Bc·32)."""
        st = self._device_state()
        return hs.prg_expand_core(
            st["seeds"][which], hs.as_bytes(b"mpcium-ot-prg|" + tag, self.device),
            Bc, blk_off,
        )

    # -- check verdicts / blame / tamper hook --------------------------------

    def _store_verdicts(self, **named: np.ndarray) -> None:
        """Merge per-check verdicts of the last invocation:
        {"kos": (B,), "gilboa": (S, B), "consistency": (S, B)} bool."""
        v = self.check_verdicts or {}
        v.update(named)
        self.check_verdicts = v

    def check_blame(self) -> Optional[List[Optional[Tuple[str, str]]]]:
        """Per-lane blame from the last invocation's verdicts: None for a
        clean lane, else ("alice"|"bob", check name). A KOS failure
        dominates its lane (a corrupted extension garbles the pads, so
        the payload checks fail as a side effect). None when checks were
        off."""
        v = self.check_verdicts
        if not v:
            return None
        kos = v.get("kos")
        gil = v.get("gilboa")
        con = v.get("consistency")
        Bn = next(iter(v.values())).shape[-1]
        out: List[Optional[Tuple[str, str]]] = []
        for i in range(Bn):
            if kos is not None and not kos[i]:
                out.append(("alice", CHECK_KOS))
            elif gil is not None and not gil[:, i].all():
                out.append(("bob", CHECK_GILBOA))
            elif con is not None and not con[:, i].all():
                out.append(("bob", CHECK_CONSISTENCY))
            else:
                out.append(None)
        return out

    def set_tamper(self, spec: Optional[Dict]) -> None:
        """Install a deterministic wire corruption for the next run_multi
        calls: the leg then runs the three-round composition and flips
        one byte of one wire field between rounds. spec keys: field
        ("U" | "kos_xbar" | "kos_tbar" | "y0" | "y1" | "D" | "B_pt" |
        "Beta_pt"), lane, set (payload fields), byte, xor (default
        0x01). None clears."""
        self._tamper = spec

    def _verify_inprocess(
        self, tag, rows_a, rows_b, U, r_bits, b_list, z_red, y0s, y1s, sels, alphas,
    ):
        """Full-width check pass of the in-process run: the kernels the
        wire rounds run, on the same wire tensors, so the verdicts equal
        the three-round composition's. ψ is derived once per set and
        shared by both roles (both derive it from the same y0, y1)."""
        kos_pref = _fs_prefixes(tag, b"kos", device=self.device)
        xbar, tbar = _k_kos_tags(rows_a, r_bits, U, *kos_pref)
        kos_ok = _k_kos_verify(
            rows_b, self._device_state()["delta_bits"], U, xbar, tbar, *kos_pref
        )
        g_oks, c_oks = [], []
        for s, b_s in enumerate(b_list):
            pref = _fs_prefixes(tag, b"gilboa", s, self.device)
            psi = _psi_weights(y0s[s], y1s[s], *pref)
            D_b, B_comp, Beta_comp = _k_gilboa_bob(
                y0s[s], y1s[s], z_red[s], b_s, *pref, psi=psi
            )
            msel = sels[s].reshape(b_s.shape[0], NBITS, 32)
            g_oks.append(_k_gilboa_alice(
                y0s[s], y1s[s], msel, r_bits, D_b, B_comp, *pref, psi=psi
            ))
            c_oks.append(_k_consistency(alphas[s], r_bits, B_comp, Beta_comp))
        self.check_verdicts = {
            "kos": _host(kos_ok),  # mpcflow: host-ok — check verdicts are the abort decision (B bools per extension)
            "gilboa": _host(torch.stack(g_oks)),  # mpcflow: host-ok — check verdicts are the abort decision (S·B bools per extension)
            "consistency": _host(torch.stack(c_oks)),  # mpcflow: host-ok — check verdicts are the abort decision (S·B bools per extension)
        }

    # -- the host route's chunk stages ----------------------------------------
    #
    # Each covers lanes [blk_off, blk_off + Bc): a contiguous block range
    # of every PRG stream and a contiguous column range of the extension
    # matrix, so the chunks give the bytes of the full-width rounds.

    def _ext_alice_chunk(self, tag: bytes, r_packed_c: np.ndarray, blk_off: int, Bc: int):
        """Alice's half for one chunk → (t0_c, U_c), each (κ, Bc·32); U is
        assembled in place in the t1 buffer."""
        t0 = _prg_host(self.k0, tag, Bc, blk_off)
        t1 = _prg_host(self.k1, tag, Bc, blk_off)
        native.xor_rows(t1, t0)          # t1 ← t0 ^ t1
        native.xor_rows(t1, r_packed_c)  # ... ^ r (row broadcast)
        return t0, t1

    def _ext_bob_chunk(self, tag: bytes, U_c: np.ndarray, blk_off: int, Bc: int) -> np.ndarray:
        """Bob's half for one chunk: U folded into the Δ=1 rows of his
        keystream → Q_c (κ, Bc·32), built in place."""
        tD = _prg_host(self.keysD, tag, Bc, blk_off)
        for r in self._delta_rows:
            tD[r] ^= U_c[r]
        return tD

    def _pads_chunk(self, tag, n_sets, t0_c, Qm_c, m_off, m_count):
        """Transpose and pad hashing for one chunk, both roles, every
        payload set → (padsA [pad_s], padsB [(pad0_s, pad1_s)])."""
        prefixes = self._pad_prefixes(tag, n_sets)
        padsA = _derive_pads_multi(prefixes, t0_c, m_count, m_off=m_off)
        padsB = _derive_pads_multi(prefixes, Qm_c, m_count, delta=self.delta_packed,
                                   m_off=m_off)
        return padsA, padsB

    # -- Alice ---------------------------------------------------------------

    def alice_round1(self, a: torch.Tensor, ctr: int) -> Dict:
        """``a``: (B, n) scalars mod q. → {"U": (κ, M/8), "v"} to Bob,
        plus the KOS tags {"kos_xbar", "kos_tbar"} when checks are on
        (χ is derived from U, so no extra round); local state kept for
        round 3."""
        B = a.shape[0]
        M = B * NBITS
        r_bits = _bits_256(a.to(self.device)).to(torch.uint8).reshape(M)
        tag = self._ext_tag(ctr)
        t0, t1 = self._prg(slice(0, 2), tag, 0, B).unbind(0)
        U = t0 ^ t1 ^ hs.pack_bits_core(r_bits)[None, :]
        self._alice_state = (t0, r_bits, B, tag)
        self.check_verdicts = None
        msg = {"U": _host(U), "v": OT_WIRE_VERSION}  # mpcflow: host-ok — the extension matrix U is wire bytes (κ·M/8 per extension)
        if ot_checks_enabled():
            xbar, tbar = _k_kos_tags(
                hs.ot_transpose_core(t0), r_bits, U,
                *_fs_prefixes(tag, b"kos", device=self.device),
            )
            msg["kos_xbar"] = _host(xbar)  # mpcflow: host-ok — KOS tags are wire bytes (B·(κ/8+κ²/8) per extension)
            msg["kos_tbar"] = _host(tbar)  # mpcflow: host-ok — KOS tags are wire bytes (B·(κ/8+κ²/8) per extension)
        return msg

    def alice_round3(self, bob_msg: Dict) -> torch.Tensor:
        """Recover the selected payloads → Alice's share (B, n) mod q."""
        return self.alice_round3_multi((bob_msg,))[0]

    def alice_round3_multi(self, bob_msgs) -> List[torch.Tensor]:
        """One extension, several payload sets (see bob_round2_multi).
        With checks on, verifies each set's Gilboa and consistency
        openings against the RECEIVED payload bytes (Alice is the
        verifier; failures blame Bob)."""
        checks = ot_checks_enabled()
        for i, m in enumerate(bob_msgs):
            if m.get("v") != OT_WIRE_VERSION:
                raise ValueError(
                    f"OT-MtA wire version mismatch in bob msg {i}: got "
                    f"{m.get('v')!r}, this party speaks v{OT_WIRE_VERSION}"
                )
            if checks and "D" not in m:
                raise ValueError(
                    f"OT-MtA checks enabled but bob msg {i} carries no "
                    "Gilboa opening (peer running MPCIUM_OT_CHECKS=0?)"
                )
        t0, r_bits, B, tag = self._alice_state
        M = B * NBITS
        dev = self.device
        pads = hs.pad_hash_core(
            _prefix_rows(self._pad_prefixes(tag, len(bob_msgs)), dev),
            hs.ot_transpose_core(t0), _pad_idx(0, M, dev),
        )
        sel_bits = r_bits.bool()[:, None]
        alphas, g_oks, c_oks = [], [], []
        for s, bob_msg in enumerate(bob_msgs):
            y0 = hs.as_bytes(bob_msg["y0"], dev)
            y1 = hs.as_bytes(bob_msg["y1"], dev)
            sel = (torch.where(sel_bits, y1, y0) ^ pads[s]).reshape(B, NBITS, 32)
            alpha = _sum_mod_q(_reduce_bytes(sel))
            alphas.append(alpha)
            if checks:
                pref = _fs_prefixes(tag, b"gilboa", s, dev)
                B_pt = hs.as_bytes(bob_msg["B_pt"], dev)
                g_oks.append(_k_gilboa_alice(
                    y0, y1, sel, r_bits, hs.as_bytes(bob_msg["D"], dev), B_pt, *pref,
                ))
                c_oks.append(_k_consistency(
                    alpha, r_bits, B_pt, hs.as_bytes(bob_msg["Beta_pt"], dev)
                ))
        if checks:
            self._store_verdicts(
                gilboa=_host(torch.stack(g_oks)),  # mpcflow: host-ok — check verdicts are the abort decision (S·B bools per extension)
                consistency=_host(torch.stack(c_oks)),  # mpcflow: host-ok — check verdicts are the abort decision (S·B bools per extension)
            )
        return alphas

    # -- Bob -----------------------------------------------------------------

    def bob_round2(
        self, b_scalars: torch.Tensor, alice_msg: Dict, ctr: int
    ) -> Tuple[Dict, torch.Tensor]:
        """``b_scalars``: (B, n) mod q. → ({"y0", "y1", "v"} to Alice,
        Bob's share (B, n) mod q)."""
        msgs, betas = self.bob_round2_multi((b_scalars,), alice_msg, ctr)
        return msgs[0], betas[0]

    def bob_round2_multi(
        self, b_list, alice_msg: Dict, ctr: int
    ) -> Tuple[List[Dict], List[torch.Tensor]]:
        """Several payload sets against ONE extension (GG18 multiplies the
        same k_a by γ_b and w_b): the extension runs once, each set is
        masked under its own pad domain (`…|s0`, `…|s1`). With checks
        on, verifies Alice's KOS tags against the received U (Bob is the
        verifier; failure blames Alice) and attaches each set's opening
        {"D", "B_pt", "Beta_pt"}."""
        checks = ot_checks_enabled()
        b_list = tuple(b_list)
        if any(b.shape != b_list[0].shape for b in b_list):
            raise ValueError(
                "bob_round2_multi: payload sets disagree on batch shape: "
                f"{[tuple(b.shape) for b in b_list]}"
            )
        if alice_msg.get("v") != OT_WIRE_VERSION:
            # mpclint: disable=MPF702 — the formatted value is the public wire-version field (a small int every peer sees), not the PRG-derived tensors that taint the message dict
            raise ValueError(
                f"OT-MtA wire version mismatch: alice msg carries "
                f"{alice_msg.get('v')!r}, this party speaks "
                f"v{OT_WIRE_VERSION} (mixed-version quorum?)"
            )
        if checks and "kos_xbar" not in alice_msg:
            raise ValueError(
                "OT-MtA checks enabled but alice msg carries no KOS "
                "tags (peer running MPCIUM_OT_CHECKS=0?)"
            )
        dev = self.device
        st = self._device_state()
        B = b_list[0].shape[0]
        M = B * NBITS
        tag = self._ext_tag(ctr)
        U = hs.as_bytes(alice_msg["U"], dev)
        Qm = self._prg(slice(2, 3), tag, 0, B)[0] ^ (U & st["delta_mask"])
        rows_b = hs.ot_transpose_core(Qm)
        if checks:
            kos_ok = _k_kos_verify(
                rows_b, st["delta_bits"], U,
                hs.as_bytes(alice_msg["kos_xbar"], dev),
                hs.as_bytes(alice_msg["kos_tbar"], dev),
                *_fs_prefixes(tag, b"kos", device=dev),
            )
            self._store_verdicts(kos=_host(kos_ok))  # mpcflow: host-ok — check verdicts are the abort decision (B bools per extension)
        # (S, 2, M, 32): pad0, pad1 per set
        pads = hs.pad_hash_core(
            _prefix_rows(self._pad_prefixes(tag, len(b_list)), dev)[:, None, :],
            torch.stack([rows_b, rows_b ^ st["delta_packed"][None, :]])[None],
            _pad_idx(0, M, dev),
        )
        msgs, betas = [], []
        for s, b_scalars in enumerate(b_list):
            b_scalars = b_scalars.to(dev)
            # payloads: z and z + 2^i·b (mod q), z freshly random per OT
            z_raw = hs.as_bytes(
                np.frombuffer(self.rng.token_bytes(M * 32), np.uint8).reshape(B, NBITS, 32),
                dev,
            )
            z_red = _reduce_bytes(z_raw)
            m1 = _m1_payloads(z_red, _pow2_ladder(b_scalars))
            m0 = bn.limbs_to_bytes_le(z_red, P256, 32)
            y0 = pads[s, 0] ^ m0.reshape(M, 32)
            y1 = pads[s, 1] ^ m1.reshape(M, 32)
            msg = {"y0": _host(y0), "y1": _host(y1), "v": OT_WIRE_VERSION}  # mpcflow: host-ok — OT payloads, pad-masked on device, are wire bytes (M·64 per set)
            if checks:
                D_b, B_comp, Beta_comp = _k_gilboa_bob(
                    y0, y1, z_red, b_scalars, *_fs_prefixes(tag, b"gilboa", s, dev),
                )
                msg["D"] = _host(D_b)  # mpcflow: host-ok — Gilboa openings are wire bytes (B·98 per set)
                msg["B_pt"] = _host(B_comp)  # mpcflow: host-ok — Gilboa openings are wire bytes (B·98 per set)
                msg["Beta_pt"] = _host(Beta_comp)  # mpcflow: host-ok — Gilboa openings are wire bytes (B·98 per set)
            msgs.append(msg)
            betas.append(_neg_sum_mod_q(z_red))
        return msgs, betas

    # -- in-process (the engine path) ----------------------------------------

    def run(self, a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both roles locally → (alice_share, bob_share), (B, n) each,
        with alice_share + bob_share ≡ a·b (mod q) per lane."""
        (pair,) = self.run_multi(a, (b,))
        return pair

    def run_multi(
        self,
        a: torch.Tensor,
        b_list,
        chunks: Optional[int] = None,
        timings: Optional[Dict[str, float]] = None,
        transcript: Optional[list] = None,
    ):
        """Both roles locally, several Bob scalars against one ``a`` (ONE
        extension) → [(alpha_s, beta_s)] with alpha_s + beta_s ≡ a·b_s
        (mod q) per lane.

        Two routes with the bytes of the three-round composition (the z
        draw order, PRG block schedule and pad domains are shared), each
        in ``chunks`` sub-batches (:func:`resolve_chunks`) whose
        boundaries are PRG-block and OT-index origins, the checks run
        once over the whole batch on the device:

        * device (default): each chunk is one :func:`_ot_chunk_device`;
          the host sees no extension matrix, pad or choice bit.
        * host (``MPCIUM_OT_DEVICE=0``, or more than ``MAX_PAYLOAD_SETS``
          sets): :meth:`_run_multi_host`, the pipelined extension over
          the native library.

        ``timings`` (optional dict) accumulates total_s and checks_s, and
        on the host route host_s (the worker's busy time), host_wait_s and
        device_wait_s (the main thread's waits); the device is
        synchronized at the boundaries when it is given. ``transcript``
        (optional list; device route) receives one {"U", "y0", "y1"} dict
        of host arrays per chunk — the wire bytes."""
        b_list = tuple(b_list)
        if any(b.shape != b_list[0].shape for b in b_list):
            raise ValueError(
                "run_multi: payload sets disagree on batch shape: "
                f"{[tuple(b.shape) for b in b_list]}"
            )
        self.check_verdicts = None  # per invocation; the check pass refills
        if self._tamper is not None:
            return self._run_multi_tampered(a, b_list)
        B = a.shape[0]
        K = resolve_chunks(B, chunks)
        ctr = self.ctr
        self.ctr += 1
        tag = self._ext_tag(ctr)
        M = B * NBITS
        t_total0 = time.perf_counter()
        t_span0 = tracing.now_ns()
        # z randomness: one draw per payload set, in the serial order —
        # the only rng use, so neither chunking nor the worker can move
        # the stream
        z_raw = [
            np.frombuffer(self.rng.token_bytes(M * 32), np.uint8).reshape(B, NBITS, 32)
            for _ in b_list
        ]
        if device_path_enabled() and len(b_list) <= MAX_PAYLOAD_SETS:
            out = self._run_multi_device(a, b_list, K, tag, z_raw, timings, transcript,
                                         t_total0)
            attrs = dict(host_wait_s=0.0, device_wait_s=0.0, chunks=K, sets=len(b_list),
                         device=True, checks=ot_checks_enabled())
        else:
            out, attrs = self._run_multi_host(a, b_list, K, tag, z_raw, timings, t_total0)
        # the extension's span, with the JAX leg's attributes for its route
        tracing.emit("phase:ot_extension", t_span0, tracing.now_ns(),
                     node="engine", tid=f"ot:B{B}", **attrs)
        return out

    def _run_multi_tampered(self, a, b_list):
        """The three-round composition with one corruption applied to the
        cheating party's outbound message: Alice's fields (U, KOS tags)
        before Bob's round 2, Bob's (payloads, openings) before Alice's
        round 3, so the verdicts are the receiving verifier's."""
        spec = self._tamper
        ctr = self.ctr
        self.ctr += 1
        msg_a = self.alice_round1(a, ctr)
        applied = _apply_tamper(spec, msg_a)
        msgs_b, betas = self.bob_round2_multi(b_list, msg_a, ctr)
        if not applied:
            target = msgs_b[int(spec.get("set", 0))]
            if not _apply_tamper(spec, target):
                raise ValueError(
                    f"tamper field {spec['field']!r} absent from both "
                    "rounds (checks disabled?)"
                )
        alphas = self.alice_round3_multi(msgs_b)
        return list(zip(alphas, betas))

    def _run_multi_host(self, a, b_list, K, tag, z_raw, timings, t_total0):
        """The host pipelined extension (see run_multi) → (shares, span
        attributes). The choice bits come to the host first (they drive
        the host stage); then the payload math of every chunk and set is
        queued on the device and every chunk's host stage is submitted to
        the ``ot-host`` worker, before the main thread waits on either."""
        dev = self.device
        B = a.shape[0]
        M = B * NBITS
        Bc = B // K
        Mc = Bc * NBITS
        n_sets = len(b_list)
        b_list = [b.to(dev) for b in b_list]
        r_bits_d = _bits_256(a.to(dev)).to(torch.uint8).reshape(M)
        r_bits = _host(r_bits_d)  # mpcflow: host-ok — host/native path (MPCIUM_OT_DEVICE=0): choice bits drive the host IKNP stage; the default device path never pulls them
        r_packed = _pack(r_bits)

        # device stage 1 (queued, nothing waited on): the payloads per
        # (chunk, set) and Bob's shares
        z_red = [_reduce_bytes(hs.as_bytes(z, dev)) for z in z_raw]
        payloads = [
            [(bn.limbs_to_bytes_le(z[c * Bc:(c + 1) * Bc], P256, 32),
              _m1_payloads(z[c * Bc:(c + 1) * Bc], _pow2_ladder(b[c * Bc:(c + 1) * Bc])))
             for z, b in zip(z_red, b_list)]
            for c in range(K)
        ]
        betas = [_neg_sum_mod_q(z) for z in z_red]
        checks = ot_checks_enabled()

        def host_stage(c: int):
            t_busy = time.perf_counter()
            blk_off = c * Bc
            t0_c, U_c = self._ext_alice_chunk(
                tag, r_packed[blk_off * 32:(blk_off + Bc) * 32], blk_off, Bc
            )
            Qm_c = self._ext_bob_chunk(tag, U_c, blk_off, Bc)
            pads = self._pads_chunk(tag, n_sets, t0_c, Qm_c, c * Mc, Mc)
            if timings is not None:
                timings["host_s"] = timings.get("host_s", 0.0) + time.perf_counter() - t_busy
            return pads, t0_c, U_c, Qm_c

        # the double buffer: every chunk's host stage is queued before the
        # first wait on a device tensor
        futs = [_host_pool().submit(host_stage, c) for c in range(K)]

        host_wait = device_wait = 0.0
        alpha_pieces: List[List[torch.Tensor]] = [[] for _ in range(n_sets)]
        t0_cs, U_cs, Qm_cs = [], [], []  # per-chunk wire tensors, for the checks
        y_cs = [([], [], []) for _ in range(n_sets)]  # (y0, y1, sel) per set
        for c in range(K):
            t_w = time.perf_counter()
            (padsA, padsB), t0_c, U_c, Qm_c = futs[c].result()
            host_wait += time.perf_counter() - t_w
            if checks:
                t0_cs.append(t0_c)
                U_cs.append(U_c)
                Qm_cs.append(Qm_c)
            sel_bits = r_bits[c * Mc:(c + 1) * Mc, None].astype(bool)
            for s, (m0_d, m1_d) in enumerate(payloads[c]):
                t_w = time.perf_counter()
                m0 = _host(m0_d).reshape(Mc, 32)  # mpcflow: host-ok — host/native path (MPCIUM_OT_DEVICE=0): payloads meet the host-derived pads here; the default device path masks on device
                m1 = _host(m1_d).reshape(Mc, 32)  # mpcflow: host-ok — host/native path (MPCIUM_OT_DEVICE=0): payloads meet the host-derived pads here; the default device path masks on device
                device_wait += time.perf_counter() - t_w
                pad0, pad1 = padsB[s]
                # mask into the pads (the worker's fresh buffers, dead after)
                y0 = native.xor_rows(pad0, m0)
                y1 = native.xor_rows(pad1, m1)
                sel = np.where(sel_bits, y1, y0)
                native.xor_rows(sel, padsA[s])
                alpha_pieces[s].append(
                    _sum_mod_q(_reduce_bytes(hs.as_bytes(sel.reshape(Bc, NBITS, 32), dev)))
                )
                if checks:
                    for acc, arr in zip(y_cs[s], (y0, y1, sel)):
                        acc.append(arr)

        alphas = [torch.cat(p) for p in alpha_pieces]
        checks_s = 0.0
        if checks:
            if timings is not None:
                self._sync()
            t_chk = time.perf_counter()

            def up(arrs, axis=0):
                return hs.as_bytes(np.concatenate(arrs, axis=axis), dev)

            self._verify_inprocess(
                tag, hs.ot_transpose_core(up(t0_cs, 1)), hs.ot_transpose_core(up(Qm_cs, 1)),
                up(U_cs, 1), r_bits_d, b_list, z_red,
                [up(ys[0]) for ys in y_cs], [up(ys[1]) for ys in y_cs],
                [up(ys[2]) for ys in y_cs], alphas,
            )
            checks_s = time.perf_counter() - t_chk
        if timings is not None:
            self._sync()
            for key, v in (("checks_s", checks_s), ("host_wait_s", host_wait),
                           ("device_wait_s", device_wait),
                           ("total_s", time.perf_counter() - t_total0)):
                timings[key] = timings.get(key, 0.0) + v
        attrs = dict(host_wait_s=round(host_wait, 6), device_wait_s=round(device_wait, 6),
                     chunks=K, sets=n_sets, checks=checks)
        return list(zip(alphas, betas)), attrs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            with no_capture():  # not while another thread captures a CUDA graph
                torch.cuda.synchronize(self.device)  # mpcflow: host-ok — timing instrumentation, only when the caller passes timings

    def _run_multi_device(self, a, b_list, K, tag, z_raw, timings, transcript, t_total0):
        """Per chunk: the payload math, then :func:`_ot_chunk_device`. The
        host never sees the extension matrices, pads or choice bits."""
        dev = self.device
        B = a.shape[0]
        M = B * NBITS
        Bc = B // K
        Mc = Bc * NBITS
        n_sets = len(b_list)
        st = self._device_state()
        prg_prefix = hs.as_bytes(b"mpcium-ot-prg|" + tag, dev)
        pad_prefixes = _prefix_rows(self._pad_prefixes(tag, n_sets), dev)
        b_list = [b.to(dev) for b in b_list]
        r_bits = _bits_256(a.to(dev)).to(torch.uint8).reshape(M)
        r_packed = hs.pack_bits_core(r_bits)
        z_red = [_reduce_bytes(hs.as_bytes(z, dev)) for z in z_raw]

        checks = ot_checks_enabled()
        pieces = []  # per chunk: (alphas, U, y0s, y1s, rows_a, rows_b, sels)
        for c in range(K):
            sl = slice(c * Bc, (c + 1) * Bc)
            m0s = torch.stack([bn.limbs_to_bytes_le(z[sl], P256, 32) for z in z_red])
            m1s = torch.stack([
                _m1_payloads(z[sl], _pow2_ladder(b[sl])) for z, b in zip(z_red, b_list)
            ])
            out = _ot_chunk_device(
                st, prg_prefix, pad_prefixes, r_bits[c * Mc:(c + 1) * Mc],
                r_packed[c * Bc * 32:(c + 1) * Bc * 32], m0s, m1s, c * Bc, c * Mc,
            )
            pieces.append(out if checks else out[:1])
            if transcript is not None:
                _alphas, U_c, y0s_c, y1s_c = out[:4]
                transcript.append({
                    "U": _host(U_c),  # mpcflow: host-ok — transcript-oracle capture (tests only; None in production)
                    "y0": [_host(y) for y in y0s_c],  # mpcflow: host-ok — transcript-oracle capture (tests only; None in production)
                    "y1": [_host(y) for y in y1s_c],  # mpcflow: host-ok — transcript-oracle capture (tests only; None in production)
                })

        def cat(i: int, dim: int) -> torch.Tensor:
            return torch.cat([p[i] for p in pieces], dim=dim)

        alphas = cat(0, 1).unbind(0)
        betas = [_neg_sum_mod_q(z) for z in z_red]
        if checks:
            if timings is not None:
                self._sync()
            t_chk = time.perf_counter()
            self._verify_inprocess(
                tag, cat(4, 0), cat(5, 0), cat(1, 1), r_bits, b_list, z_red,
                cat(2, 1), cat(3, 1), cat(6, 1), alphas,
            )
            if timings is not None:
                timings["checks_s"] = timings.get("checks_s", 0.0) + (
                    time.perf_counter() - t_chk
                )
        if timings is not None:
            self._sync()
            timings["total_s"] = timings.get("total_s", 0.0) + (
                time.perf_counter() - t_total0
            )
        return list(zip(alphas, betas))
