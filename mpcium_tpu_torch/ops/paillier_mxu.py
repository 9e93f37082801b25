"""Batched Paillier for the GG18 signing hot path (PyTorch).

The port of ``mpcium_tpu/ops/paillier_mxu.py``:

1. **Short-randomizer encryption.** A random unit y is fixed at key load
   and h = y^N mod N² precomputed; for a 256-bit u, r = y^u and
   r^N = h^u are fixed-base exponentiations (comb tables).
2. **CRT decryption** mod p² and q² with the exponents p-1, q-1, then a
   CRT combine mod q.
3. Every modular multiply goes through :mod:`ops.modmul`, hence through
   the mulmod kernel on the GPU.
"""
from __future__ import annotations

import os
import secrets
from typing import Optional, Tuple

import torch

from ..core import bignum as bn
from ..core.paillier import PaillierPrivateKey, PaillierPublicKey
from . import modmul as mm

# short-randomizer exponent width (2 x 128-bit security)
RAND_BITS = int(os.environ.get("MPCIUM_PAILLIER_RAND_BITS", "256"))


class PaillierMXU:
    """Batched Paillier for one public key over a session axis."""

    def __init__(self, pk: PaillierPublicKey, y: Optional[int] = None,
                 rng=secrets, device=None):
        self.pk = pk
        self.ctx_N = mm.MXUBarrett(pk.N, device=device)
        self.device = self.ctx_N.device
        self.ctx_N2 = mm.MXUBarrett(pk.N2, device=self.device)
        self.prof_n = self.ctx_N.prof
        self.prof_n2 = self.ctx_N2.prof
        # short-randomizer base: y uniform unit mod N (gcd≠1 ⇒ factoring N)
        self.y = y if y is not None else (rng.randbelow(pk.N - 2) + 2)
        self.h = pow(self.y, pk.N, pk.N2)
        self._N_T = mm._const_matrices(pk.N, self.prof_n.n_limbs, device=self.device)

    def enc_deterministic(self, m_limbs: torch.Tensor) -> torch.Tensor:
        """(1 + m·N) mod N² for m < N (exact: (1+mN) < N²)."""
        mN = mm.carry(mm.mul_const(m_limbs, self._N_T))
        out = bn.take_limbs(mN, 0, self.prof_n2.n_limbs).clone()
        out[..., 0] += 1
        return mm.carry(out)

    def encrypt(
        self, m_limbs: torch.Tensor, u_bits: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """c = (1+mN)·h^u mod N², r = y^u mod N; ``u_bits`` (..., RAND_BITS)
        int32 bits. r is the effective randomizer (c == (1+mN)·r^N)."""
        hu = self.ctx_N2.powmod_fixed_base(self.h, u_bits)
        c = self.ctx_N2.mulmod(self.enc_deterministic(m_limbs), hu)
        r = self.ctx_N.powmod_fixed_base(self.y % self.pk.N, u_bits)
        return c, r

    def add(self, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
        return self.ctx_N2.mulmod(c1, c2)

    def scalar_mul(self, c: torch.Tensor, k_bits: torch.Tensor) -> torch.Tensor:
        return self.ctx_N2.powmod(c, k_bits)


class PaillierMXUPrivate(PaillierMXU):
    """Adds CRT decryption (private-key holder side)."""

    def __init__(self, sk: PaillierPrivateKey, y: Optional[int] = None,
                 rng=secrets, device=None):
        super().__init__(sk.public, y=y, rng=rng, device=device)
        self.sk = sk
        p, q = sk.p, sk.q
        dev = self.device
        self.ctx_p2 = mm.MXUBarrett(p * p, device=dev)
        self.ctx_q2 = mm.MXUBarrett(q * q, device=dev)
        self.ctx_p = mm.MXUBarrett(p, device=dev)
        self.ctx_q = mm.MXUBarrett(q, device=dev)
        # L_p(x) = (x-1)/p as multiplication by p^-1 mod R^k (x-1 is an
        # exact multiple of p, so the low limbs of the product are exact)
        kp = self.ctx_p2.prof.n_limbs
        kq = self.ctx_q2.prof.n_limbs
        Rp = 1 << (mm.LIMB_BITS * kp)
        Rq = 1 << (mm.LIMB_BITS * kq)
        self._pinv_T = mm._const_matrices(pow(p, -1, Rp), kp, device=dev)
        self._qinv_T = mm._const_matrices(pow(q, -1, Rq), kq, device=dev)

        def _L(x: int, r: int) -> int:
            return (x - 1) // r

        self.h_p = pow(_L(pow(1 + sk.N, p - 1, p * p), p), -1, p)
        self.h_q = pow(_L(pow(1 + sk.N, q - 1, q * q), q), -1, q)
        # CRT combine: m = m_p + p·((m_q - m_p)·p^-1 mod q)
        self.p_inv_mod_q = pow(p, -1, q)
        self._p_T_wide = mm._const_matrices(p, self.ctx_q.prof.n_limbs, device=dev)

    def _half_decrypt(self, c, ctx2, ctx1, r: int, hr: int, inv_T) -> torch.Tensor:
        """m_r = L_r(c^(r-1) mod r²)·h_r mod r → limbs in ctx1's profile."""
        u = ctx2.powmod_const_exp(ctx2.reduce(c), r - 1)
        # u - 1 via the complement trick: u + (R^k - 1) mod R^k == u - 1
        k = ctx2.prof.n_limbs
        u_minus = mm.carry(bn.pad_limbs(u + mm.MASK, 1))[..., :k]
        L = mm.carry(mm.mul_const(u_minus, inv_T))[..., :k]
        # exact division: L = (u-1)/r < r — fits the mod-r context
        return ctx1.mulmod_const(bn.take_limbs(L, 0, ctx1.prof.n_limbs), hr)

    def decrypt(self, c: torch.Tensor) -> torch.Tensor:
        """Batched CRT decrypt → plaintext limbs mod N (prof_n)."""
        p, q = self.sk.p, self.sk.q
        m_p = self._half_decrypt(c, self.ctx_p2, self.ctx_p, p, self.h_p, self._pinv_T)
        m_q = self._half_decrypt(c, self.ctx_q2, self.ctx_q, q, self.h_q, self._qinv_T)
        nq = self.ctx_q.prof.n_limbs
        mq_q = self.ctx_q.reduce(bn.take_limbs(m_q, 0, nq))
        mp_q = self.ctx_q.reduce(bn.take_limbs(m_p, 0, nq))
        t = self.ctx_q.mulmod_const(self.ctx_q.submod(mq_q, mp_q), self.p_inv_mod_q)
        # m = m_p + p·t  (< p·q = N; exact, no modular reduction needed)
        pt = mm.carry(mm.mul_const(t, self._p_T_wide))
        n = self.prof_n.n_limbs
        return mm.carry(bn.take_limbs(pt, 0, n) + bn.take_limbs(m_p, 0, n))
