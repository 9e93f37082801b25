"""Batched GG18 threshold-ECDSA signing (PyTorch).

The port of ``mpcium_tpu/engine/gg18_batch.py``: B concurrent (t+1)-of-n
signing sessions whose round compute is batched per party on one device.
The MtA runs on one of two backends, ``mta_impl`` (default
``MPCIUM_MTA``, else ``"paillier"``):

- ``"paillier"``: the GG18 MtA with range proofs, below;
- ``"ot"``: Gilboa multiplication over IKNP-extended OTs with KOS,
  Gilboa-encoding and consistency checks (:mod:`protocol.ecdsa.mta_ot`);
  no Paillier anywhere, and a lane whose check fails aborts the cohort
  with the culprit named (:class:`engine.abort.CohortAbort`);
- ``"none"`` (:meth:`GG18BatchCoSigners.curve_only`): curve state only,
  for sharding probes; it cannot sign.

- curve ops ride :mod:`core.secp256k1` (12-bit limbs);
- Paillier / ring-Pedersen arithmetic rides :mod:`ops.modmul` via
  :mod:`ops.paillier_mxu` — every modular multiply is the hand-written
  CUDA mulmod kernel on a GPU;
- commitments and Fiat–Shamir challenges hash on the device
  (:mod:`ops.sha256`) over the same fixed-width byte rows as the JAX
  engine, so transcripts, and with a seeded stream signatures, are
  byte-identical to it.

Randomness: every secret is drawn through ``rng.token_bytes`` /
``rng.randbelow`` in the JAX engine's order, full batch, before any
cohort split. Batch verification of the s^N ciphertext legs follows
``MPCIUM_BATCH_VERIFY`` (``rand``: one combined small-exponent check with
a strict per-session fallback; ``strict``: per session).
"""
from __future__ import annotations

import os
import secrets
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import bignum as bn
from ..core import hostmath as hm
from ..core import secp256k1 as sp
from ..core.bignum import I32, P256
from ..core.fields import secp256k1_field
from ..core.paillier import PaillierPublicKey, PreParams
from ..device import resolve
from ..ops import modmul as mm
from ..ops.paillier_mxu import RAND_BITS, PaillierMXU, PaillierMXUPrivate
from ..ops.sha256 import sha256 as dev_sha256
from ..protocol.base import KeygenShare, party_xs
from ..protocol.ecdsa import mta_ot
from ..utils import tracing
from . import pipeline as pl
from .abort import CohortAbort

Q = hm.SECP_N
SCALAR_BITS = 256
BATCH_VERIFY = os.environ.get("MPCIUM_BATCH_VERIFY", "rand")
RHO_BITS = 128
_TAG = b"mpcium-tpu/gg18-batch/"  # wire constant, shared with the JAX engine


def _fold_add(x: torch.Tensor, extra_limbs: int = 3) -> torch.Tensor:
    """Σ over the batch axis of normalized 7-bit limbs → (1, n+extra)."""
    assert x.shape[0] <= (1 << 17)
    x = bn.pad_limbs(x, extra_limbs)
    return mm.carry(torch.sum(x, dim=0, keepdim=True))


def _host_pow_single(x_limbs: torch.Tensor, exp: int, ctx) -> torch.Tensor:
    """(1, n) limbs → x^exp mod ctx.modulus by one host modexp."""
    v = bn.batch_from_limbs(x_limbs, ctx.prof)[0]
    return torch.as_tensor(
        bn.batch_to_limbs([pow(v, exp, ctx.modulus)], ctx.prof), device=ctx.device
    )


def _host_pow_batch(x_limbs: torch.Tensor, exp: int, ctx) -> torch.Tensor:
    """(B, n) limbs → x^exp per element on the host (strict fallback)."""
    vals = bn.batch_from_limbs(x_limbs, ctx.prof)
    return torch.as_tensor(
        bn.batch_to_limbs([pow(v, exp, ctx.modulus) for v in vals], ctx.prof),
        device=ctx.device,
    )


@dataclass(frozen=True)
class Domains:
    """Exponent-domain bit sizes (GG18 appendix A). Shrunk in unit tests."""

    scalar: int = 256
    alpha: int = 760        # < q³
    beta_prime: int = 1272  # < q⁵
    gamma_bob: int = 1784   # < q⁷
    rho_extra: int = 248
    s1_bound: int = 768

    def q3(self) -> int:
        return Q**3


def _prof7(bits: int) -> bn.LimbProfile:
    """Unpadded 7-bit profile (proof-domain integers)."""
    return bn.LimbProfile(bits=7, n_limbs=max(2, -(-bits // 7)))


def rand_bits(batch: int, bits: int, rng=secrets) -> np.ndarray:
    """(B, ceil(bits/8)) random bytes encoding a uniform ``bits``-bit int."""
    nbytes = -(-bits // 8)
    raw = np.frombuffer(rng.token_bytes(batch * nbytes), dtype=np.uint8)
    out = raw.reshape(batch, nbytes).copy()
    extra = 8 * nbytes - bits
    if extra:
        out[:, -1] &= (1 << (8 - extra)) - 1
    return out


def rand_bit_tensor(batch: int, bits: int, rng=secrets, device=None) -> torch.Tensor:
    """(B, bits) int32 uniform bits, LSB-first per value."""
    by = rand_bits(batch, bits, rng)
    arr = np.unpackbits(by, axis=-1, bitorder="little")[:, :bits]
    return torch.as_tensor(arr.astype(np.int32), device=device)


def dev_hash(tag: bytes, *rows: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256 on the device over tag ‖ fixed-width rows → (B, 32)."""
    rows = [r.to(torch.uint8) for r in rows]
    B = rows[0].shape[0]
    t = torch.tensor(list(_TAG + tag), dtype=torch.uint8, device=rows[0].device)
    t = t.expand(B, -1)
    return dev_sha256(torch.cat([t] + rows, dim=-1))


def _bits_of(x: torch.Tensor, prof: bn.LimbProfile, n_bits: int) -> torch.Tensor:
    return bn.limbs_to_bits(x, prof, n_bits)


def _int_mul_add(e, m, add, prof) -> torch.Tensor:
    """e·m + add over plain integers, normalized to the width of ``prof``."""
    prod = mm.mul_pair(e, m)
    width = prof.n_limbs
    return mm.carry(bn.take_limbs(prod, 0, width) + bn.take_limbs(add, 0, width))


def _eq_all(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def _bits_pack(bits: torch.Tensor, prof: bn.LimbProfile) -> torch.Tensor:
    """(..., n_bits) LSB-first bit tensor → normalized limbs in prof."""
    return bn._bits_to_groups(bits.to(torch.int64), prof.bits, prof.n_limbs).to(I32)


# ---------------------------------------------------------------------------
# per-party static contexts
# ---------------------------------------------------------------------------


class PartyCtx:
    """One signer's static crypto material + device contexts. The normal
    constructor holds the party's PRIVATE material; :meth:`public` builds
    a peer's context from its public material (N, NTilde, h1, h2)."""

    def __init__(
        self,
        pid: str,
        pre: Optional[PreParams],
        rng=secrets,
        *,
        public_material: Optional[Tuple[int, int, int, int]] = None,
        device=None,
    ):
        self.pid = pid
        self.pre = pre
        self.device = resolve(device)
        if public_material is not None:
            if pre is not None:
                raise ValueError("pass private PreParams OR public material")
            N, NTilde, h1, h2 = public_material
            self.pmx = PaillierMXU(PaillierPublicKey(N), rng=rng, device=self.device)
            self._common(N, NTilde, h1, h2)
        else:
            if pre is None:
                raise ValueError("private PartyCtx requires PreParams")
            self.pmx = PaillierMXUPrivate(pre.paillier, rng=rng, device=self.device)
            self._common(pre.paillier.N, pre.NTilde, pre.h1, pre.h2)

    @classmethod
    def public(cls, pid: str, N: int, NTilde: int, h1: int, h2: int,
               rng=secrets, device=None) -> "PartyCtx":
        return cls(pid, None, rng, public_material=(N, NTilde, h1, h2), device=device)

    def _common(self, N: int, NTilde: int, h1: int, h2: int) -> None:
        self.N = N
        self.NTilde = NTilde
        self.ctx_nt = mm.MXUBarrett(NTilde, device=self.device)
        self.h1 = h1
        self.h2 = h2
        self.nt_bytes = -(-NTilde.bit_length() // 8)
        self.n2_bytes = -(-(2 * N.bit_length()) // 8)
        self.n_bytes = -(-N.bit_length() // 8)

    def commit_ring(self, m_bits: torch.Tensor, r_bits: torch.Tensor) -> torch.Tensor:
        """h1^m · h2^r mod NTilde — two comb-table fixed-base exps."""
        a = self.ctx_nt.powmod_fixed_base(self.h1, m_bits)
        b = self.ctx_nt.powmod_fixed_base(self.h2, r_bits)
        return self.ctx_nt.mulmod(a, b)

    def nt_row(self, x: torch.Tensor) -> torch.Tensor:
        return bn.limbs_to_bytes_le(x, self.ctx_nt.prof, self.nt_bytes)

    def n2_row(self, x: torch.Tensor) -> torch.Tensor:
        return bn.limbs_to_bytes_le(x, self.pmx.prof_n2, self.n2_bytes)


# ---------------------------------------------------------------------------
# batched MtA with range proofs (one ordered direction Alice → Bob → Alice)
# ---------------------------------------------------------------------------


class MtaBatch:
    """Batched MtA + proofs for the ordered pair (alice, bob)."""

    def __init__(self, alice: PartyCtx, bob: PartyCtx, dom: Domains = Domains()):
        self.alice = alice
        self.bob = bob
        self.dom = dom
        self.device = alice.device
        d = dom
        self.p_e = _prof7(d.scalar)
        self.p_alpha = _prof7(d.alpha)
        self.p_s1 = _prof7(d.scalar + d.alpha + 7)
        nt_bits = bob.NTilde.bit_length()
        nt_bits_a = alice.NTilde.bit_length()
        self.p_rho = _prof7(d.scalar + max(nt_bits, nt_bits_a) + d.rho_extra)
        self.p_s2 = _prof7(d.scalar + self.p_rho.n_limbs * 7 + 7)
        self.p_bp = _prof7(d.beta_prime)
        self.p_gb = _prof7(d.gamma_bob)
        self.p_t1 = _prof7(d.scalar + d.gamma_bob + 7)

    # -- randomness bundles (host stream → device) --------------------------

    def _dom_limbs(self, B, bits, prof, rng):
        return bn.bytes_to_limbs_le(
            torch.as_tensor(rand_bits(B, bits, rng), device=self.device),
            prof, prof.n_limbs,
        )

    def _bits(self, B, bits, rng):
        return rand_bit_tensor(B, bits, rng, self.device)

    def alice_randoms(self, B: int, rng=secrets) -> Dict[str, torch.Tensor]:
        d = self.dom
        nt_b = self.bob.NTilde.bit_length()
        return {
            "u_enc": self._bits(B, RAND_BITS, rng),
            "alpha": self._dom_limbs(B, d.alpha - 8, self.p_alpha, rng),
            "rho": self._dom_limbs(B, d.scalar + nt_b - 8, self.p_rho, rng),
            "gamma": self._dom_limbs(B, d.alpha + nt_b - 8, self.p_s2, rng),
        }

    def bob_randoms(self, B: int, rng=secrets) -> Dict[str, torch.Tensor]:
        d = self.dom
        nt_a = self.alice.NTilde.bit_length()
        return {
            "beta_prime": self._dom_limbs(B, d.beta_prime - 8, self.p_bp, rng),
            "u_bp": self._bits(B, RAND_BITS, rng),
            "alpha": self._dom_limbs(B, d.alpha - 8, self.p_alpha, rng),
            "rho": self._dom_limbs(B, d.scalar + nt_a - 8, self.p_rho, rng),
            "rho_p": self._dom_limbs(B, d.alpha + nt_a - 8, self.p_s2, rng),
            "sigma": self._dom_limbs(B, d.scalar + nt_a - 8, self.p_rho, rng),
            "tau": self._dom_limbs(B, d.alpha + nt_a - 8, self.p_s2, rng),
            "u_g": self._bits(B, RAND_BITS, rng),
            "gamma": self._dom_limbs(B, d.gamma_bob - 8, self.p_gb, rng),
        }

    # -- Alice: range proof for c_a = Enc_A(m; y^u) -------------------------

    def alice_init(self, m_limbs, R: Dict[str, torch.Tensor]):
        A, Bo = self.alice, self.bob
        z = Bo.commit_ring(
            _bits_of(m_limbs, A.pmx.prof_n, self.dom.scalar),
            _bits_of(R["rho"], self.p_rho, self.p_rho.n_limbs * 7),
        )
        u_c, _u_r = A.pmx.encrypt(
            bn.take_limbs(R["alpha"], 0, A.pmx.prof_n.n_limbs), R["u_enc"]
        )
        w = Bo.commit_ring(
            _bits_of(R["alpha"], self.p_alpha, self.dom.alpha),
            _bits_of(R["gamma"], self.p_s2, self.p_s2.n_limbs * 7),
        )
        return {"z": z, "u": u_c, "w": w}

    def alice_challenge(self, c_a, T) -> torch.Tensor:
        A, Bo = self.alice, self.bob
        return dev_hash(
            b"alice", A.n2_row(c_a), Bo.nt_row(T["z"]), A.n2_row(T["u"]),
            Bo.nt_row(T["w"]),
        )

    def e_limbs(self, e32: torch.Tensor) -> torch.Tensor:
        return bn.bytes_to_limbs_le(e32, self.p_e, self.p_e.n_limbs)

    def e_limbs_from(self, e) -> torch.Tensor:
        """Accept either raw (B, 32) digest bytes or already-packed limbs."""
        if e.shape[-1] == 32 and e.dtype == torch.uint8:
            return self.e_limbs(e)
        return e

    def alice_finish(self, e, m_limbs, R, u_ca_bits):
        """s = y^(u_ca·e + u_enc) mod N; s1 = e·m + α; s2 = e·ρ + γ."""
        A = self.alice
        p_u = _prof7(RAND_BITS)
        u_ca = _bits_pack(u_ca_bits, p_u)
        u_enc = _bits_pack(R["u_enc"], p_u)
        prod = mm.mul_pair(u_ca, self.e_limbs_from(e))
        p_E = _prof7(2 * RAND_BITS + 8)
        E = mm.carry(
            bn.take_limbs(prod, 0, p_E.n_limbs) + bn.take_limbs(u_enc, 0, p_E.n_limbs)
        )
        s = A.pmx.ctx_N.powmod_fixed_base(
            A.pmx.y % A.N, _bits_of(E, p_E, p_E.n_limbs * 7)
        )
        m_e = bn.take_limbs(m_limbs, 0, self.p_e.n_limbs)
        e_l = self.e_limbs_from(e)
        s1 = _int_mul_add(
            e_l, m_e, bn.take_limbs(R["alpha"], 0, self.p_s1.n_limbs), self.p_s1
        )
        s2 = _int_mul_add(
            e_l, R["rho"], bn.take_limbs(R["gamma"], 0, self.p_s2.n_limbs), self.p_s2
        )
        return {"s": s, "s1": s1, "s2": s2}

    def _q3_limbs(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(
            bn.to_limbs(self.dom.q3(), self.p_s1), device=self.device
        ).expand(like.shape)

    def bob_check_alice(self, c_a, T, P, e, rng=secrets) -> torch.Tensor:
        """Batched Alice-proof verification → (B,) bool."""
        A, Bo = self.alice, self.bob
        e_l = self.e_limbs_from(e)
        ok = bn.compare(P["s1"], self._q3_limbs(P["s1"])) <= 0
        e_bits = _bits_of(e_l, self.p_e, self.dom.scalar)
        s1_modN = A.pmx.ctx_N.reduce(
            bn.take_limbs(P["s1"], 0, min(P["s1"].shape[-1], 2 * A.pmx.prof_n.n_limbs))
        )
        ok = ok & self._alice_enc_leg(c_a, T, P, e_bits, s1_modN, rng)
        lhs2 = Bo.commit_ring(
            _bits_of(P["s1"], self.p_s1, self.p_s1.n_limbs * 7),
            _bits_of(P["s2"], self.p_s2, self.p_s2.n_limbs * 7),
        )
        rhs2 = Bo.ctx_nt.mulmod(T["w"], Bo.ctx_nt.powmod(T["z"], e_bits))
        return ok & _eq_all(lhs2, rhs2)

    def _alice_enc_leg_strict(self, c_a, T, P, e_bits, s1_modN) -> torch.Tensor:
        """Enc_det(s1)·s^N == u·c_a^e (mod N²), per session."""
        A = self.alice
        n2 = A.pmx.ctx_N2
        lhs = n2.mulmod(
            A.pmx.enc_deterministic(s1_modN),
            _host_pow_batch(bn.take_limbs(P["s"], 0, n2.prof.n_limbs), A.N, n2),
        )
        rhs = n2.mulmod(T["u"], n2.powmod(c_a, e_bits))
        return _eq_all(lhs, rhs)

    def _alice_enc_leg(self, c_a, T, P, e_bits, s1_modN, rng) -> torch.Tensor:
        """Ciphertext leg, batch-verified: Enc_det(Σρ·s1) · (Πs^ρ)^N ==
        Π(u·c_a^e)^ρ; the strict per-session check attributes failures."""
        if BATCH_VERIFY != "rand":
            return self._alice_enc_leg_strict(c_a, T, P, e_bits, s1_modN)
        A = self.alice
        n2 = A.pmx.ctx_N2
        B = s1_modN.shape[0]
        rho_bits = self._bits(B, RHO_BITS, rng)
        rhs = n2.mulmod(T["u"], n2.powmod(c_a, e_bits))
        Rp = n2.prod_over_batch(n2.powmod(rhs, rho_bits))[None]
        s2 = bn.take_limbs(P["s"], 0, n2.prof.n_limbs)
        Sp = n2.prod_over_batch(n2.powmod(s2, rho_bits))[None]
        SN = _host_pow_single(Sp, A.N, n2)
        rho_l = _bits_pack(rho_bits, _prof7(RHO_BITS))
        tot = A.pmx.ctx_N.reduce(_fold_add(mm.mul_pair(rho_l, s1_modN)))
        lhs = n2.mulmod(A.pmx.enc_deterministic(tot), SN)
        if bool(_eq_all(lhs, Rp)[0]):  # mpcflow: host-ok — single aggregated proof verdict gates the strict fallback
            return torch.ones((B,), dtype=torch.bool, device=self.device)
        return self._alice_enc_leg_strict(c_a, T, P, e_bits, s1_modN)

    # -- Bob: homomorphic response + proof ----------------------------------

    def bob_respond(self, c_a, b_limbs, R):
        """c_b = c_a^b · Enc_A(β′; y^u_bp); pre-challenge transcript."""
        A = self.alice
        b_bits = _bits_of(b_limbs, self.p_e, self.dom.scalar)
        enc_bp, _r = A.pmx.encrypt(
            bn.take_limbs(R["beta_prime"], 0, A.pmx.prof_n.n_limbs), R["u_bp"]
        )
        c_b = A.pmx.ctx_N2.mulmod(A.pmx.ctx_N2.powmod(c_a, b_bits), enc_bp)
        z = A.commit_ring(
            _bits_of(b_limbs, self.p_e, self.dom.scalar),
            _bits_of(R["rho"], self.p_rho, self.p_rho.n_limbs * 7),
        )
        z_p = A.commit_ring(
            _bits_of(R["alpha"], self.p_alpha, self.dom.alpha),
            _bits_of(R["rho_p"], self.p_s2, self.p_s2.n_limbs * 7),
        )
        t = A.commit_ring(
            _bits_of(R["beta_prime"], self.p_bp, self.dom.beta_prime),
            _bits_of(R["sigma"], self.p_rho, self.p_rho.n_limbs * 7),
        )
        enc_g, _r2 = A.pmx.encrypt(
            bn.take_limbs(R["gamma"], 0, A.pmx.prof_n.n_limbs), R["u_g"]
        )
        v = A.pmx.ctx_N2.mulmod(
            A.pmx.ctx_N2.powmod(c_a, _bits_of(R["alpha"], self.p_alpha, self.dom.alpha)),
            enc_g,
        )
        w = A.commit_ring(
            _bits_of(R["gamma"], self.p_gb, self.dom.gamma_bob),
            _bits_of(R["tau"], self.p_s2, self.p_s2.n_limbs * 7),
        )
        return {"c_b": c_b, "z": z, "z_p": z_p, "t": t, "v": v, "w": w}

    def bob_challenge(self, c_a, T, extra_rows: Sequence = ()) -> torch.Tensor:
        A = self.alice
        rows = [
            A.n2_row(c_a), A.n2_row(T["c_b"]), A.nt_row(T["z"]), A.nt_row(T["z_p"]),
            A.nt_row(T["t"]), A.n2_row(T["v"]), A.nt_row(T["w"]),
        ]
        rows.extend(extra_rows)
        return dev_hash(b"bob", *rows)

    def bob_finish(self, e, b_limbs, R):
        A = self.alice
        e_l = self.e_limbs_from(e)
        p_u = _prof7(RAND_BITS)
        u_bp = _bits_pack(R["u_bp"], p_u)
        u_g = _bits_pack(R["u_g"], p_u)
        prod = mm.mul_pair(u_bp, e_l)
        p_E = _prof7(2 * RAND_BITS + 8)
        E = mm.carry(
            bn.take_limbs(prod, 0, p_E.n_limbs) + bn.take_limbs(u_g, 0, p_E.n_limbs)
        )
        s = A.pmx.ctx_N.powmod_fixed_base(
            A.pmx.y % A.N, _bits_of(E, p_E, p_E.n_limbs * 7)
        )
        s1 = _int_mul_add(
            e_l, bn.take_limbs(b_limbs, 0, self.p_e.n_limbs),
            bn.take_limbs(R["alpha"], 0, self.p_s1.n_limbs), self.p_s1,
        )
        s2 = _int_mul_add(
            e_l, R["rho"], bn.take_limbs(R["rho_p"], 0, self.p_s2.n_limbs), self.p_s2
        )
        t1 = _int_mul_add(
            e_l, bn.take_limbs(R["beta_prime"], 0, self.p_t1.n_limbs),
            bn.take_limbs(R["gamma"], 0, self.p_t1.n_limbs), self.p_t1,
        )
        t2 = _int_mul_add(
            e_l, R["sigma"], bn.take_limbs(R["tau"], 0, self.p_s2.n_limbs), self.p_s2
        )
        return {"s": s, "s1": s1, "s2": s2, "t1": t1, "t2": t2}

    def alice_check_bob(self, c_a, T, P, e, rng=secrets) -> torch.Tensor:
        """Batched Bob-proof verification (ciphertext + ring legs; the
        with-check curve leg is checked by the caller)."""
        A = self.alice
        e_l = self.e_limbs_from(e)
        ok = bn.compare(P["s1"], self._q3_limbs(P["s1"])) <= 0
        t1_cap = (1 << (self.p_t1.bits * self.p_t1.n_limbs)) - 1
        q7 = torch.as_tensor(
            bn.to_limbs(min(Q**7, t1_cap), self.p_t1), device=self.device
        ).expand(P["t1"].shape)
        ok = ok & (bn.compare(P["t1"], q7) <= 0)
        e_bits = _bits_of(e_l, self.p_e, self.dom.scalar)
        lhs = A.commit_ring(
            _bits_of(P["s1"], self.p_s1, self.p_s1.n_limbs * 7),
            _bits_of(P["s2"], self.p_s2, self.p_s2.n_limbs * 7),
        )
        rhs = A.ctx_nt.mulmod(T["z_p"], A.ctx_nt.powmod(T["z"], e_bits))
        ok = ok & _eq_all(lhs, rhs)
        lhs = A.commit_ring(
            _bits_of(P["t1"], self.p_t1, self.p_t1.n_limbs * 7),
            _bits_of(P["t2"], self.p_s2, self.p_s2.n_limbs * 7),
        )
        rhs = A.ctx_nt.mulmod(T["w"], A.ctx_nt.powmod(T["t"], e_bits))
        ok = ok & _eq_all(lhs, rhs)
        n2 = A.pmx.ctx_N2
        t1_modN = A.pmx.ctx_N.reduce(
            bn.take_limbs(P["t1"], 0, min(P["t1"].shape[-1], 2 * A.pmx.prof_n.n_limbs))
        )
        # ciphertext leg: c_a^s1 · Enc_det(t1) · s^N == v · c_b^e (mod N²)
        M = n2.mulmod(
            n2.powmod(c_a, _bits_of(P["s1"], self.p_s1, self.p_s1.n_limbs * 7)),
            A.pmx.enc_deterministic(t1_modN),
        )
        rhs = n2.mulmod(T["v"], n2.powmod(T["c_b"], e_bits))
        s_lift = bn.take_limbs(P["s"], 0, n2.prof.n_limbs)
        if BATCH_VERIFY == "rand":
            B = s_lift.shape[0]
            rho_bits = self._bits(B, RHO_BITS, rng)
            Mp = n2.prod_over_batch(n2.powmod(M, rho_bits))[None]
            Sp = n2.prod_over_batch(n2.powmod(s_lift, rho_bits))[None]
            Rp = n2.prod_over_batch(n2.powmod(rhs, rho_bits))[None]
            SN = _host_pow_single(Sp, A.N, n2)
            if bool(_eq_all(n2.mulmod(Mp, SN), Rp)[0]):  # mpcflow: host-ok — single aggregated proof verdict gates the strict fallback
                return ok
        lhs = n2.mulmod(M, _host_pow_batch(s_lift, A.N, n2))
        return ok & _eq_all(lhs, rhs)

    def alice_decrypt_share(self, c_b) -> torch.Tensor:
        """Dec_A(c_b) mod q → curve-scalar limbs (12-bit family)."""
        A = self.alice
        return _mod_q_from_limbs(A.pmx.decrypt(c_b), A.pmx.prof_n)


# ---------------------------------------------------------------------------
# curve-side helpers (12-bit family)
# ---------------------------------------------------------------------------


def _ring(t: torch.Tensor) -> bn.BarrettCtx:
    return sp.scalar_ring(t.device)


def _bits256(k: torch.Tensor) -> torch.Tensor:
    return bn.limbs_to_bits(k, P256, SCALAR_BITS)


def _scalar_from_wide_bytes(b: torch.Tensor) -> torch.Tensor:
    """(..., 40) uniform bytes → canonical scalar mod q (bias 2^-64)."""
    return _ring(b).reduce(bn.bytes_to_limbs_le(b, P256, 30))


def _base_mul_compressed(k_limbs: torch.Tensor):
    pt = sp.base_mul(_bits256(k_limbs))
    return pt, sp.compress(pt)


def _scalar_to_plain(pmx, k_limbs: torch.Tensor) -> torch.Tensor:
    """curve scalar (12-bit limbs) → Paillier plaintext limbs (7-bit)."""
    b = bn.limbs_to_bytes_le(k_limbs, P256, 32)
    return bn.bytes_to_limbs_le(b, pmx.prof_n, pmx.prof_n.n_limbs)


def _scalar_to_prof(k_limbs: torch.Tensor, prof: bn.LimbProfile) -> torch.Tensor:
    b = bn.limbs_to_bytes_le(k_limbs, P256, 32)
    return bn.bytes_to_limbs_le(b, prof, prof.n_limbs)


def _mod_q_from_limbs(x: torch.Tensor, prof: bn.LimbProfile) -> torch.Tensor:
    """Reduce an arbitrary-width non-negative value mod q → 12-bit curve
    limbs: v = Σ chunk_i · 2^(176·i) mod q, folded from the top."""
    ring = _ring(x)
    n_bytes = -(-prof.n_limbs * prof.bits // 8)
    b = bn.limbs_to_bytes_le(x, prof, n_bytes)
    chunk_bytes = 22  # 176 bits per chunk < 2^253
    n_chunks = -(-n_bytes // chunk_bytes)
    b = bn.pad_limbs(b, n_chunks * chunk_bytes - n_bytes)
    chunks = b.reshape(b.shape[:-1] + (n_chunks, chunk_bytes))
    acc = None
    shift_l = ring.const(pow(2, chunk_bytes * 8, Q), x.shape[:-1])
    for i in range(n_chunks - 1, -1, -1):
        c = ring.reduce(bn.bytes_to_limbs_le(chunks[..., i, :], P256, P256.n_limbs))
        acc = c if acc is None else ring.addmod(ring.mulmod(acc, shift_l), c)
    return acc


def _idx_row(i: int, B: int, device) -> torch.Tensor:
    return torch.full((B, 1), i, dtype=torch.uint8, device=device)


def _blk_gamma(gamma_i, blind_i, idx):
    """Γ_i = γ_i·G, compressed + hash-committed (round 1, per party)."""
    pt, comp = _base_mul_compressed(gamma_i)
    return pt, comp, dev_hash(b"gamma", idx, blind_i, comp)


def _blk_gamma_check(blind_i, comp_i, idx, commit_i):
    return _eq_all(dev_hash(b"gamma", idx, blind_i, comp_i), commit_i)


def _blk_R(delta, Gamma_sum):
    """δ⁻¹·ΣΓ, r = R_x mod q, recovery metadata, degeneracy flags."""
    ring = _ring(delta)
    ok = ~torch.all(delta == 0, dim=-1)
    delta_inv = ring.powmod_const(delta, Q - 2)
    R_pt = sp.scalar_mul(_bits256(delta_inv), Gamma_sum)
    F = secp256k1_field(delta.device)
    zi = F.inv(R_pt.Z)
    Rx = F.canonical(F.mul(R_pt.X, zi))
    r = ring.reduce(Rx)
    ok = ok & ~torch.all(r == 0, dim=-1)
    y_aff = F.canonical(F.mul(R_pt.Y, zi))
    n_l = torch.as_tensor(bn.to_limbs(Q, P256), device=delta.device)
    rec = (y_aff[..., 0] & 1) | torch.where(bn.compare(Rx, n_l) >= 0, 2, 0).to(I32)
    return ok, R_pt, r, rec


def _hash_scalar(tag: bytes, *rows: torch.Tensor) -> torch.Tensor:
    """Fiat–Shamir challenge: SHA-256 of the tagged rows, reduced mod q."""
    e32 = dev_hash(tag, *rows)
    return _ring(e32).reduce(bn.bytes_to_limbs_le(e32, P256, 22))


# -- the PoK blocks: prover and verifier run on different nodes in the
# distributed party; the in-process fabric composes them ----------------


def _blk_schnorr_prove(kpok_i, gamma_i, comp_i, idx):
    """Schnorr PoK of γ_i, prover side → (A_comp, s_pok)."""
    ring = _ring(kpok_i)
    _A_pt, A_comp = _base_mul_compressed(kpok_i)
    e = _hash_scalar(b"schnorr", idx, A_comp, comp_i)
    return A_comp, ring.submod(kpok_i, ring.mulmod(e, gamma_i))


def _blk_schnorr_verify(A_comp, s_pok, Gamma_i, comp_i, idx) -> torch.Tensor:
    """Schnorr PoK verify: s·G + e·Γ ?= A → (B,) bool."""
    e = _hash_scalar(b"schnorr", idx, A_comp, comp_i)
    lhs = sp.add(sp.base_mul(_bits256(s_pok)), sp.scalar_mul(_bits256(e), Gamma_i))
    return _eq_all(sp.compress(lhs), A_comp)


def _blk_schnorr(kpok_i, gamma_i, Gamma_i, comp_i, idx):
    """Batched Schnorr PoK of γ_i: prove, then verify (honest fabric)."""
    A_comp, s_pok = _blk_schnorr_prove(kpok_i, gamma_i, comp_i, idx)
    return _blk_schnorr_verify(A_comp, s_pok, Gamma_i, comp_i, idx)


def _blk_va(m, r, k_i, sigma_i, l_i, rho_i, R_pt, blind_i, idx):
    """Phase 5A per party: s_i, V_i = s_i·R + l_i·G, A_i = ρ_i·G, commit."""
    ring = _ring(m)
    s_i = ring.addmod(ring.mulmod(m, k_i), ring.mulmod(r, sigma_i))
    V_i = sp.add(sp.scalar_mul(_bits256(s_i), R_pt), sp.base_mul(_bits256(l_i)))
    A_i = sp.base_mul(_bits256(rho_i))
    vc, ac = sp.compress(V_i), sp.compress(A_i)
    return s_i, V_i, A_i, vc, ac, dev_hash(b"VA", idx, blind_i, vc, ac)


def _blk_pedersen_prove(ka, kb, s_i, l_i, R_pt, vc, ac, idx):
    """Phase-5B PedersenPoK of (s_i, l_i), prover side → (Apok_comp, sa, sb)."""
    ring = _ring(ka)
    Apok = sp.add(sp.scalar_mul(_bits256(ka), R_pt), sp.base_mul(_bits256(kb)))
    Apok_comp = sp.compress(Apok)
    e5 = _hash_scalar(b"pedersen", idx, Apok_comp, vc, ac)
    sa = ring.submod(ka, ring.mulmod(e5, s_i))
    sb = ring.submod(kb, ring.mulmod(e5, l_i))
    return Apok_comp, sa, sb


def _blk_pedersen_verify(Apok_comp, sa, sb, V_i, R_pt, vc, ac, idx) -> torch.Tensor:
    """Phase-5B PedersenPoK verify: sa·R + sb·G + e·V ?= Apok."""
    e5 = _hash_scalar(b"pedersen", idx, Apok_comp, vc, ac)
    lhs = sp.add(
        sp.add(sp.scalar_mul(_bits256(sa), R_pt), sp.base_mul(_bits256(sb))),
        sp.scalar_mul(_bits256(e5), V_i),
    )
    return _eq_all(sp.compress(lhs), Apok_comp)


def _blk_va_check(blind_i, vc, ac, idx, commit) -> torch.Tensor:
    """Phase-5B decommit check of a (V_c, A_c) commitment."""
    return _eq_all(dev_hash(b"VA", idx, blind_i, vc, ac), commit)


def _blk_pedersen(ka, kb, s_i, l_i, V_i, R_pt, vc, ac, blind_i, idx, commit):
    """Phase 5B per party: decommit check, then the PedersenPoK of
    (s_i, l_i) proved and verified (honest fabric)."""
    ok = _blk_va_check(blind_i, vc, ac, idx, commit)
    Apok_comp, sa, sb = _blk_pedersen_prove(ka, kb, s_i, l_i, R_pt, vc, ac, idx)
    return ok & _blk_pedersen_verify(Apok_comp, sa, sb, V_i, R_pt, vc, ac, idx)


def _blk_W_from_vss(C_comp: torch.Tensor, xj: int, lam_bits: torch.Tensor):
    """W_j = λ_j · Σ_k x_j^k · C_k from aggregated VSS commitments.

    ``C_comp``: (t+1, B, 33) compressed commitment points (wallet order),
    ``xj``: the party's Shamir x (a small public int), ``lam_bits``: the
    (256,) LSB-first bits of λ_j, shared by the batch. Returns (W
    points, ok mask of the decompressions)."""
    pts, ok_all = sp.decompress(C_comp)
    ok = torch.all(ok_all, dim=0)
    xj_bits = torch.as_tensor(
        sp.scalars_to_bits([xj], n_bits=max(1, xj.bit_length()))[0], device=C_comp.device
    )
    t1 = C_comp.shape[0]
    acc = sp.SecpPointJ(*(c[t1 - 1] for c in pts))
    for k in range(t1 - 2, -1, -1):
        acc = sp.add(sp.scalar_mul(xj_bits, acc), sp.SecpPointJ(*(c[k] for c in pts)))
    return sp.scalar_mul(lam_bits, acc), ok


def _blk_V(V_sum, m, r, Y):
    """V = ΣV_i - m·G - r·Y (phase 5C prelude)."""
    return sp.add(
        V_sum,
        sp.add(sp.neg(sp.base_mul(_bits256(m))), sp.neg(sp.scalar_mul(_bits256(r), Y))),
    )


def _blk_ut(rho_i, l_i, V, A_sum, blind_i, idx):
    """Phase 5C per party: U_i = ρ_i·V, T_i = l_i·ΣA, commit."""
    U_i = sp.scalar_mul(_bits256(rho_i), V)
    T_i = sp.scalar_mul(_bits256(l_i), A_sum)
    uc, tc = sp.compress(U_i), sp.compress(T_i)
    return U_i, T_i, uc, tc, dev_hash(b"UT", idx, blind_i, uc, tc)


def _blk_ut_check(blind_i, uc, tc, idx, commit):
    return _eq_all(dev_hash(b"UT", idx, blind_i, uc, tc), commit)


def _blk_final(s, m, r, Y, rec):
    """Low-s normalize + batched ECDSA verification x(u1·G+u2·Y) == r."""
    ring = _ring(s)
    ok = ~torch.all(s == 0, dim=-1)
    half = torch.as_tensor(bn.to_limbs(Q // 2, P256), device=s.device)
    high = bn.compare(s, half) > 0
    s = torch.where(high[..., None], ring.negmod(s), s)
    rec = torch.where(high, rec ^ 1, rec)
    s_inv = ring.powmod_const(s, Q - 2)
    u1 = ring.mulmod(m, s_inv)
    u2 = ring.mulmod(r, s_inv)
    Rv = sp.add(sp.base_mul(_bits256(u1)), sp.scalar_mul(_bits256(u2), Y))
    ok = ok & torch.all(ring.reduce(sp.x_coordinate(Rv)) == r, dim=-1)
    return ok, s, rec


def _step_final(st: Dict[str, torch.Tensor], Y) -> Dict[str, torch.Tensor]:
    """Phase-5E combine and in-protocol verify as one round step over the
    carried state {s, m, r, rec, ok} → {r, s, rec, ok}."""
    ok_f, s, rec = _blk_final(st["s"], st["m"], st["r"], Y, st["rec"])
    return {"r": st["r"], "s": s, "rec": rec, "ok": st["ok"] & ok_f}


def _withcheck_curve(s1_q, e_q, U_pt, W_pt):
    """MtAwc curve binding: s1·G ?= U + e·W → (B,) bool."""
    lhs = sp.base_mul(_bits256(s1_q))
    rhs = sp.add(U_pt, sp.scalar_mul(_bits256(e_q), W_pt))
    return sp.equal(lhs, rhs)


def _slice_pt(pt, sl: slice):
    return type(pt)(*(leaf[sl] for leaf in pt))


def _sig_egress(r, s, rec, ok) -> Dict[str, np.ndarray]:
    """Signature egress: device limbs → host big-endian bytes."""
    return {
        "r": bn.limbs_to_bytes_le(r, P256, 32).cpu().numpy()[:, ::-1].copy(),  # mpcflow: host-ok — signature egress
        "s": bn.limbs_to_bytes_le(s, P256, 32).cpu().numpy()[:, ::-1].copy(),  # mpcflow: host-ok — signature egress
        "recovery": rec.to(I32).cpu().numpy(),  # mpcflow: host-ok — signature egress
        "ok": ok.cpu().numpy(),  # mpcflow: host-ok — per-wallet verdicts, egress with the signatures
    }


# ---------------------------------------------------------------------------
# q-party batched co-signing fabric
# ---------------------------------------------------------------------------


class GG18BatchCoSigners:
    """Runs B concurrent (t+1)-of-n GG18 signing sessions with every
    signer's round compute batched on ``device`` (default: the GPU;
    raises when there is none — pass ``device="cpu"`` for the plain CPU
    path). ``party_shares[i]`` are signer i's per-wallet shares (same
    wallet order across parties)."""

    def __init__(
        self,
        party_ids: Sequence[str],
        party_shares: Sequence[Sequence[KeygenShare]],
        preparams: Optional[Dict[str, PreParams]] = None,
        dom: Domains = Domains(),
        rng=secrets,
        *,
        mta_impl: Optional[str] = None,
        device=None,
    ):
        self.device = resolve(device)
        self.q = len(party_ids)
        assert self.q >= 2, "need at least a 2-party quorum"
        self.ids = list(party_ids)
        self.B = len(party_shares[0])
        self.dom = dom
        self.rng = rng
        self.ring = sp.scalar_ring(self.device)
        first = party_shares[0][0]
        assert self.q >= first.threshold + 1, "quorum below threshold+1"
        universe_xs = party_xs(first.participants)
        quorum_xs = [universe_xs[p] for p in party_ids]
        self.pairs = [(a, b) for a in range(self.q) for b in range(self.q) if a != b]
        self.mta_impl = mta_impl or os.environ.get("MPCIUM_MTA", "paillier")
        if self.mta_impl not in ("paillier", "ot", "none"):
            raise ValueError(
                f"MPCIUM_MTA={self.mta_impl!r}: expected 'paillier' or 'ot'"
            )
        self.ctx = self.mta = self.ot_legs = None
        self.ot_timings: Optional[Dict[str, float]] = None
        if self.mta_impl == "ot":
            # one leg per ordered pair, base OTs drawn in pair order
            self.ot_legs = {
                (a, b): mta_ot.OTMtALeg(
                    f"{party_ids[a]}->{party_ids[b]}", rng=rng, device=self.device
                )
                for (a, b) in self.pairs
            }
        elif self.mta_impl == "paillier":
            if preparams is None:
                raise ValueError("mta_impl='paillier' requires preparams")
            self.ctx = [
                PartyCtx(pid, preparams[pid], rng, device=self.device)
                for pid in party_ids
            ]
            self.mta = {
                (a, b): MtaBatch(self.ctx[a], self.ctx[b], dom) for (a, b) in self.pairs
            }
        # additive shares w_i = λ_i·x_i mod q (λ shared across the batch)
        self.w = []
        self.W_pts = []
        for pid, shares in zip(party_ids, party_shares):
            lam = hm.lagrange_coeff(quorum_xs, universe_xs[pid], Q)
            w_ints = [lam * s.share % Q for s in shares]
            w_limbs = torch.as_tensor(bn.batch_to_limbs(w_ints, P256), device=self.device)
            self.w.append(w_limbs)
            for s in shares:
                if s.key_type != "secp256k1":
                    raise ValueError("wrong key type")
                if s.self_x != universe_xs[pid]:
                    raise ValueError("party_shares misaligned with party_ids")
            W, _ = _base_mul_compressed(w_limbs)
            self.W_pts.append(W)
        pubs = [hm.secp_decompress(s.public_key) for s in party_shares[0]]
        self.Y = sp.from_host(pubs, self.device)

    @classmethod
    def curve_only(
        cls,
        party_ids: Sequence[str],
        party_shares: Sequence[Sequence[KeygenShare]],
        rng=secrets,
        *,
        device=None,
    ) -> "GG18BatchCoSigners":
        """Curve state (w, W_pts, Y) without any MtA machinery, for
        sharding probes that run the batched point math but never the
        protocol. ``sign()`` raises."""
        return cls(party_ids, party_shares, None, rng=rng, mta_impl="none", device=device)

    # -- small helpers -------------------------------------------------------

    def _rand_scalars_q(self) -> torch.Tensor:
        """(q, B, 22) uniform scalars mod q."""
        raw = rand_bits(self.q * self.B, 320, self.rng).reshape(self.q, self.B, 40)
        return _scalar_from_wide_bytes(torch.as_tensor(raw, device=self.device))

    def _blinds_q(self) -> torch.Tensor:
        return torch.as_tensor(
            rand_bits(self.q * self.B, 256, self.rng).reshape(self.q, self.B, 32),
            device=self.device,
        )

    # -- the protocol --------------------------------------------------------

    @torch.inference_mode()
    def sign(
        self, digests: np.ndarray, phase_times: Optional[dict] = None,
        cohorts: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """``digests``: (B, 32) big-endian digests. Returns r, s (B, 32
        big-endian bytes), recovery (B,) and the ok mask (B,).

        ``phase_times``: optional dict — when given, or when tracing is
        on, the engine synchronizes the device at each phase boundary and
        records wall seconds per protocol phase as ``phase:*`` spans and
        in the dict (cohorts' phases added).
        ``cohorts``: counter-phase cohort count of the signing tail
        (None → ``MPCIUM_PIPELINE_COHORTS``, default 2); signatures are
        bit-identical for every count."""
        if self.mta_impl == "none":
            raise RuntimeError("curve_only signer has no MtA contexts — cannot sign()")
        dev = self.device
        pt = tracing.PhaseTimer(
            "gg18.sign", tracing.sync_tensors, phase_times=phase_times,
            node="engine", tid=f"gg18:B{self.B}",
        )
        B, q = self.B, self.q
        ring = self.ring
        dg = torch.as_tensor(np.ascontiguousarray(digests[:, ::-1]), device=dev)
        m = ring.reduce(bn.bytes_to_limbs_le(dg, P256, 22))

        # ---- round 1: k, γ, Γ commitments; shared c_i = Enc_i(k_i) ---------
        k_st = self._rand_scalars_q()
        gamma_st = self._rand_scalars_q()
        k = [k_st[i] for i in range(q)]
        gamma = [gamma_st[i] for i in range(q)]
        g_blind = self._blinds_q()
        Gamma, Gamma_comp, g_commit = [], [], []
        for i in range(q):
            p_, comp, commit = _blk_gamma(gamma_st[i], g_blind[i], _idx_row(i, B, dev))
            Gamma.append(p_)
            Gamma_comp.append(comp)
            g_commit.append(commit)

        if self.mta_impl == "ot":
            pt.mark("r1_commit_encrypt_rangeproof", *Gamma_comp)
            alpha_shares, beta_shares = self._mta_ot(k, gamma, pt.on)
            # the OT phase's host/device split rides the span as attrs (and
            # the dict as r2_mta_ot_* keys), as in the JAX engine; on the
            # device route no host worker runs, so host and device read 0
            ot_attrs = {}
            if self.ot_timings:
                host_s = self.ot_timings.get("host_s", 0.0)
                hidden = max(0.0, host_s - self.ot_timings.get("host_wait_s", 0.0))
                ot_attrs = {
                    "host": host_s,
                    "device": self.ot_timings.get("device_wait_s", 0.0),
                    "overlap_ratio": hidden / host_s if host_s > 0 else 0.0,
                    "chunks": float(mta_ot.resolve_chunks(B)),
                }
            pt.mark("r2_mta_ot", *[alpha_shares[(a, b, "w")] for a, b in self.pairs],
                    **ot_attrs)
            self._check_blame()
            return self._finish_sign(
                pt, m, torch.ones((B,), dtype=torch.bool, device=dev),
                k, gamma, Gamma, Gamma_comp, g_commit, g_blind, alpha_shares,
                beta_shares, cohorts=cohorts,
            )

        c_k, u_k, k_plain = [], [], []
        for i in range(q):
            u_bits = rand_bit_tensor(B, RAND_BITS, self.rng, dev)
            kp = _scalar_to_plain(self.ctx[i].pmx, k[i])
            c, _r = self.ctx[i].pmx.encrypt(kp, u_bits)
            c_k.append(c)
            u_k.append(u_bits)
            k_plain.append(kp)

        mta_state: Dict[Tuple[int, int], Dict] = {}
        for (a, b) in self.pairs:
            mta = self.mta[(a, b)]
            Ra = mta.alice_randoms(B, self.rng)
            T = mta.alice_init(k_plain[a], Ra)
            e = mta.e_limbs(mta.alice_challenge(c_k[a], T))
            P = mta.alice_finish(e, k_plain[a], Ra, u_k[a])
            mta_state[(a, b)] = {"Ra": Ra, "T": T, "e": e, "P": P}
        pt.mark("r1_commit_encrypt_rangeproof", *[mta_state[p]["P"]["s"] for p in self.pairs])

        ok = torch.ones((B,), dtype=torch.bool, device=dev)

        # ---- round 2: Bob verifies + responds (γ and w) --------------------
        for (a, b) in self.pairs:
            mta = self.mta[(a, b)]
            st = mta_state[(a, b)]
            ok = ok & mta.bob_check_alice(c_k[a], st["T"], st["P"], st["e"], rng=self.rng)
            for name, secret in (("gamma", gamma[b]), ("w", self.w[b])):
                Rb = mta.bob_randoms(B, self.rng)
                b_e = _scalar_to_prof(secret, mta.p_e)
                Tb = mta.bob_respond(c_k[a], b_e, Rb)
                extra = ()
                U_pt = None
                if name == "w":
                    alpha_q = _mod_q_from_limbs(Rb["alpha"], mta.p_alpha)
                    U_pt, U_comp = _base_mul_compressed(alpha_q)
                    X_comp = sp.compress(self.W_pts[b])
                    extra = (U_comp, X_comp)
                e_b = mta.e_limbs(mta.bob_challenge(c_k[a], Tb, extra))
                Pb = mta.bob_finish(e_b, b_e, Rb)
                st[name] = {"Rb": Rb, "Tb": Tb, "e": e_b, "Pb": Pb, "U": U_pt}
        pt.mark("r2_mta_respond", ok, *[mta_state[p]["w"]["Tb"]["c_b"] for p in self.pairs])

        # ---- round 3: Alice verifies + decrypts; δ_i, σ_i ------------------
        alpha_shares = {}
        beta_shares = {}
        for (a, b) in self.pairs:
            mta = self.mta[(a, b)]
            st = mta_state[(a, b)]
            for name in ("gamma", "w"):
                sub = st[name]
                ok = ok & mta.alice_check_bob(
                    c_k[a], sub["Tb"], sub["Pb"], sub["e"], rng=self.rng
                )
                if name == "w":
                    ok = ok & _withcheck_curve(
                        _mod_q_from_limbs(sub["Pb"]["s1"], mta.p_s1),
                        _mod_q_from_limbs(sub["e"], mta.p_e),
                        sub["U"],
                        self.W_pts[b],
                    )
                alpha_shares[(a, b, name)] = mta.alice_decrypt_share(sub["Tb"]["c_b"])
                beta_shares[(a, b, name)] = ring.negmod(
                    _mod_q_from_limbs(sub["Rb"]["beta_prime"], mta.p_bp)
                )

        return self._finish_sign(
            pt, m, ok, k, gamma, Gamma, Gamma_comp, g_commit,
            g_blind, alpha_shares, beta_shares, cohorts=cohorts,
        )

    def _mta_ot(self, k, gamma, timed: bool):
        """The OT path's rounds 1-3: per ordered pair one extension serves
        both products, α + β ≡ k_a·γ_b and k_a·w_b (mod q); every leg runs
        its checks (read by :meth:`_check_blame`). → (alpha_shares,
        beta_shares) keyed (a, b, "gamma" | "w")."""
        chunks = mta_ot.resolve_chunks(self.B)
        self.ot_timings = {} if timed else None
        alpha_shares, beta_shares = {}, {}
        for (a, b) in self.pairs:
            shares = self.ot_legs[(a, b)].run_multi(
                k[a], (gamma[b], self.w[b]), chunks=chunks, timings=self.ot_timings,
            )
            for name, (al, be) in zip(("gamma", "w"), shares):
                alpha_shares[(a, b, name)] = al
                beta_shares[(a, b, name)] = be
        return alpha_shares, beta_shares

    def _check_blame(self) -> None:
        """A blamed lane aborts the cohort naming the offending (lane,
        party, check), the first blame of a lane in pair order (Alice of
        leg (a, b) is party a, Bob party b)."""
        blamed: Dict[int, Tuple[str, str]] = {}
        for (a, b) in self.pairs:
            for lane, verdict in enumerate(self.ot_legs[(a, b)].check_blame() or ()):
                if verdict is None or lane in blamed:
                    continue
                role, check = verdict
                blamed[lane] = (self.ids[a] if role == "alice" else self.ids[b], check)
        if blamed:
            raise CohortAbort(
                [(lane, pid, check) for lane, (pid, check) in sorted(blamed.items())],
                engine="gg18.sign",
            )

    def _finish_sign(
        self, pt, m, ok, k, gamma, Gamma, Gamma_comp, g_commit,
        g_blind, alpha_shares, beta_shares, cohorts: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Shared tail, cohort-pipelined: all tail randomness is drawn here,
        full batch, in the serial order, then row-sliced per cohort. Each
        cohort has its own phase timer (tid ``…:c<i>``), so the idle meter
        sees the counter-phase overlap; their phase dicts are added into
        the caller's afterwards."""
        B = self.B
        rand = {
            "kpok": self._rand_scalars_q(),
            "li": self._rand_scalars_q(),
            "ri": self._rand_scalars_q(),
            "ka": self._rand_scalars_q(),
            "kb": self._rand_scalars_q(),
            "va_blind": self._blinds_q(),
            "ut_blind": self._blinds_q(),
        }
        plan = pl.CohortPlan.for_batch(B, cohorts)
        if plan.serial:
            r_d, s_d, rec_d, ok_d = self._tail_cohort(
                pt, m, ok, k, gamma, Gamma, Gamma_comp, g_commit, g_blind,
                alpha_shares, beta_shares, rand, list(self.w), self.Y,
            )
            return _sig_egress(r_d, s_d, rec_d, ok_d)

        cohort_phases = [{} if pt.phases is not None else None for _ in range(plan.k)]

        def job(ci: int, sl: slice):
            def run():
                pt_c = tracing.PhaseTimer(
                    "gg18.sign", tracing.sync_tensors, phase_times=cohort_phases[ci],
                    node="engine", tid=f"gg18:B{B}:c{ci}",
                )
                r_d, s_d, rec_d, ok_d = self._tail_cohort(
                    pt_c, m[sl], ok[sl],
                    [x[sl] for x in k],
                    [x[sl] for x in gamma],
                    [_slice_pt(p, sl) for p in Gamma],
                    [x[sl] for x in Gamma_comp],
                    [x[sl] for x in g_commit],
                    g_blind[:, sl],
                    {kk: v[sl] for kk, v in alpha_shares.items()},
                    {kk: v[sl] for kk, v in beta_shares.items()},
                    {kk: v[:, sl] for kk, v in rand.items()},
                    [x[sl] for x in self.w],
                    _slice_pt(self.Y, sl),
                )
                res = yield ("sig_egress", lambda: _sig_egress(r_d, s_d, rec_d, ok_d))
                return res

            return run

        parts = pl.run_counter_phase([job(ci, sl) for ci, sl in enumerate(plan.slices())])
        tracing.add_phase_times(pt.phases, cohort_phases)
        return {key: pl.merge_rows([p[key] for p in parts]) for key in parts[0]}

    def _tail_cohort(
        self, pt, m, ok, k, gamma, Gamma, Gamma_comp, g_commit,
        g_blind, alpha_shares, beta_shares, rand, w, Y,
    ):
        """One cohort's tail rounds over pre-sliced lanes; returns device
        tensors (r, s, recovery, ok)."""
        B = int(m.shape[0])
        dev = m.device
        q = self.q
        ring = self.ring
        delta_i, sigma_i = [], []
        for i in range(q):
            d = ring.mulmod(k[i], gamma[i])
            s_ = ring.mulmod(k[i], w[i])
            for j in range(q):
                if j == i:
                    continue
                d = ring.addmod(
                    d, ring.addmod(alpha_shares[(i, j, "gamma")],
                                   beta_shares[(j, i, "gamma")])
                )
                s_ = ring.addmod(
                    s_, ring.addmod(alpha_shares[(i, j, "w")], beta_shares[(j, i, "w")])
                )
            delta_i.append(d)
            sigma_i.append(s_)
        pt.mark("r3_verify_decrypt", ok, *delta_i, *sigma_i)

        # ---- rounds 4-9: R reconstruction + phase 5 ----------------------
        for i in range(q):
            ok = ok & _blk_gamma_check(
                g_blind[i], Gamma_comp[i], _idx_row(i, B, dev), g_commit[i]
            )
        delta = delta_i[0]
        Gamma_sum = Gamma[0]
        for i in range(1, q):
            delta = ring.addmod(delta, delta_i[i])
            Gamma_sum = sp.add(Gamma_sum, Gamma[i])
        ok_R, R_pt, r, rec = _blk_R(delta, Gamma_sum)
        ok = ok & ok_R
        kpok = rand["kpok"]
        for i in range(q):
            ok = ok & _blk_schnorr(
                kpok[i], gamma[i], Gamma[i], Gamma_comp[i], _idx_row(i, B, dev)
            )
        pt.mark("r4_R_reconstruct_pok", ok, r)

        li, ri, ka, kb = rand["li"], rand["ri"], rand["ka"], rand["kb"]
        va_blind, ut_blind = rand["va_blind"], rand["ut_blind"]
        s_i, V_i, A_i, V_c, A_c, va_commit = [], [], [], [], [], []
        for i in range(q):
            si, Vi, Ai, vc, ac, cmt = _blk_va(
                m, r, k[i], sigma_i[i], li[i], ri[i], R_pt, va_blind[i],
                _idx_row(i, B, dev),
            )
            s_i.append(si)
            V_i.append(Vi)
            A_i.append(Ai)
            V_c.append(vc)
            A_c.append(ac)
            va_commit.append(cmt)
        for i in range(q):
            ok = ok & _blk_pedersen(
                ka[i], kb[i], s_i[i], li[i], V_i[i], R_pt, V_c[i], A_c[i],
                va_blind[i], _idx_row(i, B, dev), va_commit[i],
            )
        V_sum, A_sum = V_i[0], A_i[0]
        for i in range(1, q):
            V_sum = sp.add(V_sum, V_i[i])
            A_sum = sp.add(A_sum, A_i[i])
        V = _blk_V(V_sum, m, r, Y)
        U_pts, T_pts, U_c, T_c, ut_commit = [], [], [], [], []
        for i in range(q):
            Ui, Ti, uc, tc, cmt = _blk_ut(ri[i], li[i], V, A_sum, ut_blind[i],
                                          _idx_row(i, B, dev))
            U_pts.append(Ui)
            T_pts.append(Ti)
            U_c.append(uc)
            T_c.append(tc)
            ut_commit.append(cmt)
        for i in range(q):
            ok = ok & _blk_ut_check(ut_blind[i], U_c[i], T_c[i], _idx_row(i, B, dev),
                                    ut_commit[i])
        U_s, T_s = U_pts[0], T_pts[0]
        for i in range(1, q):
            U_s = sp.add(U_s, U_pts[i])
            T_s = sp.add(T_s, T_pts[i])
        ok = ok & sp.equal(U_s, T_s)
        s = s_i[0]
        for i in range(1, q):
            s = ring.addmod(s, s_i[i])
        st = _step_final({"s": s, "m": m, "r": r, "rec": rec, "ok": ok}, Y)
        pt.mark("r5_phase5_combine_verify", st["ok"])
        return st["r"], st["s"], st["rec"], st["ok"]


# ---------------------------------------------------------------------------
# keys: trusted-dealer keygen and keys carried over from the JAX package
# ---------------------------------------------------------------------------


def dealer_keygen_secp_batch(
    n_wallets: int,
    party_ids: Sequence[str],
    threshold: int,
    rng=secrets,
    preparams: Optional[Dict[str, PreParams]] = None,
) -> List[List[KeygenShare]]:
    """Trusted-dealer batch keygen for tests/bench setup ONLY (host-side
    python-int math; it touches no device). result[i] belongs to
    party_ids[i], wallet order aligned. With ``preparams``, shares also
    carry the keygen aux material (Paillier / ring-Pedersen maps + VSS
    commitments). Same draws, same shares as the JAX package's."""
    xs = party_xs(party_ids)
    out: List[List[KeygenShare]] = [[] for _ in party_ids]
    aux_by_pid: Dict[str, Dict] = {}
    if preparams is not None:
        for pid in party_ids:
            pre = preparams[pid]
            aux_by_pid[pid] = {
                "paillier_sk": pre.paillier.to_json(),
                "preparams": {
                    "ntilde": str(pre.NTilde), "h1": str(pre.h1), "h2": str(pre.h2),
                },
                "peer_paillier": {
                    p: str(preparams[p].paillier.N) for p in party_ids if p != pid
                },
                "peer_ring_pedersen": {
                    p: {
                        "ntilde": str(preparams[p].NTilde),
                        "h1": str(preparams[p].h1),
                        "h2": str(preparams[p].h2),
                    }
                    for p in party_ids if p != pid
                },
            }
    for _ in range(n_wallets):
        secret = rng.randbelow(Q - 1) + 1
        coeffs, shares = hm.shamir_share(
            secret, threshold, [xs[p] for p in party_ids], Q, rng=rng
        )
        pub = hm.secp_compress(hm.secp_mul(secret, hm.SECP_G))
        vss = (
            [hm.secp_compress(hm.secp_mul(c, hm.SECP_G)) for c in coeffs]
            if preparams is not None else []
        )
        for i, pid in enumerate(party_ids):
            out[i].append(KeygenShare(
                key_type="secp256k1",
                share=shares[xs[pid]],
                self_x=xs[pid],
                public_key=pub,
                vss_commitments=list(vss),
                participants=sorted(party_ids),
                threshold=threshold,
                aux=aux_by_pid.get(pid, {}),
            ))
    return out


_SHARE_FIELDS = ("key_type", "share", "self_x", "public_key", "vss_commitments",
                 "participants", "threshold", "epoch", "aux")


def shares_from_plain(party_shares) -> List[List[KeygenShare]]:
    """Keys written by the JAX package → the port's share records, so
    both packages sign for the same wallets. Each entry may be the JSON
    dict of ``KeygenShare.to_json`` or any object with the KeygenShare
    fields (ints, bytes, lists, dicts)."""
    out = []
    for shares in party_shares:
        row = []
        for s in shares:
            if isinstance(s, dict):
                row.append(KeygenShare.from_json(s))
                continue
            d = {f: getattr(s, f) for f in _SHARE_FIELDS}
            row.append(KeygenShare(
                key_type=str(d["key_type"]), share=int(d["share"]),
                self_x=int(d["self_x"]), public_key=bytes(d["public_key"]),
                vss_commitments=[bytes(c) for c in d["vss_commitments"]],
                participants=list(d["participants"]), threshold=int(d["threshold"]),
                epoch=int(d["epoch"]), aux=dict(d["aux"]),
            ))
        out.append(row)
    return out


def preparams_from_plain(d: Dict[str, dict]) -> Dict[str, PreParams]:
    """``{pid: PreParams.to_json()}`` (the JAX package's form) → the
    port's pre-parameters."""
    return {pid: PreParams.from_json(v) for pid, v in d.items()}
