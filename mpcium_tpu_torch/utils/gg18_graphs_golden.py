"""Seeded calls of the GG18 engine's graphed functions, and their record.

The JAX package jits 26 functions of ``engine/gg18_batch.py``: its MtA
limb glue, its curve helpers and its per-party round blocks. The port
graphs 25 of them (``engine.graphs.graphed("gg18")``; ``_blk_commit`` has
no caller in JAX). :func:`calls` builds one call of each at a batch of B
sessions from a numpy seed, with meaningful inputs made on the host in
python ints: honest Schnorr and Pedersen proofs, commitments and ECDSA
signatures (and on a batch of three or more, every third row tampered),
a point sum that doubles, and a zero δ. :func:`record` runs them through a
module's functions and writes every output's bytes, a point by its affine
coordinates (the projective ones are a function of the ladder, which the
port's differs from JAX's). One record format serves the JAX package on
the CPU (the committed golden ``gg18_graphs_b2.json``), the port on the
CPU (plain bodies, or replays through a stand-in capture) and the port
on the card (replays against the eager bodies, ``chip_smoke.py`` phase
36).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..core import hostmath as hm
from .ot_golden import host

FUNCTIONS = (
    "_int_mul_add", "_bits_pack", "_scalar_from_wide_bytes", "_base_mul_compressed",
    "_mod_q_from_limbs", "_blk_gamma", "_blk_gamma_check", "_blk_point_add", "_blk_point_eq",
    "_blk_R", "_blk_schnorr", "_blk_schnorr_prove", "_blk_schnorr_verify",
    "_blk_pedersen_prove", "_blk_pedersen_verify", "_blk_va_check", "_blk_W_from_vss",
    "_blk_va", "_blk_pedersen", "_blk_V", "_blk_ut", "_blk_ut_check", "_blk_final",
    "_withcheck_curve", "_step_final",
)
B, SEED = 2, 719
_DISTINCT = 8  # rows made on the host; larger batches tile them
_TAG = b"mpcium-tpu/gg18-batch/"  # the engines' hash tag prefix
Q = hm.SECP_N
# 7-bit profiles of the MtA at the default Domains: e (256 bits), s1
# (256 + 760 + 7 bits), RAND_BITS (256)
E_LIMBS, S1_LIMBS, RAND_LIMBS = 37, 147, 37


@dataclass(frozen=True)
class Prof:
    """A limb profile, built by the package under test."""

    bits: int
    n_limbs: int


@dataclass(frozen=True)
class Pts:
    """A batch of affine points (``hostmath.SecpPoint``, no identity),
    built by the package under test."""

    points: tuple


@dataclass(frozen=True)
class Pkg:
    """What :func:`to_args` and :func:`record` need of a package: numpy →
    its array on the device, a limb profile, a point batch from host
    points, and host points from a batch."""

    array: Callable
    prof: Callable
    points: Callable
    to_host: Callable


def _limbs12(vals) -> np.ndarray:
    """Python ints < 2^264 → (n, 22) int32 12-bit limbs."""
    return np.array([[(v >> (12 * i)) & 0xFFF for i in range(22)] for v in vals], np.int32)


def _limbs7(vals, n: int) -> np.ndarray:
    return np.array([[(v >> (7 * i)) & 0x7F for i in range(n)] for v in vals], np.int32)


def _tile(rows, n: int):
    return [rows[i % len(rows)] for i in range(n)]


def _comp(pt) -> np.ndarray:
    return np.frombuffer(hm.secp_compress(pt), np.uint8)


def _h(tag: bytes, *rows) -> bytes:
    return hashlib.sha256(_TAG + tag + b"".join(bytes(r) for r in rows)).digest()


def _e(tag: bytes, *rows) -> int:
    """The engines' Fiat–Shamir scalar: the digest, little-endian, mod q."""
    return int.from_bytes(_h(tag, *rows), "little") % Q


def calls(n: int = B, seed: int = SEED) -> List[Tuple[str, tuple]]:
    """One seeded call of each of :data:`FUNCTIONS` at B = ``n``: (name,
    args) of numpy arrays, :class:`Prof`, :class:`Pts`, ints and dicts."""
    rng = np.random.default_rng(seed)
    k = min(n, _DISTINCT)

    def scal():
        return [int.from_bytes(rng.bytes(32), "big") % Q for _ in range(k)]

    def bad(rows):
        """Every third row from the third on is tampered (changed by one)."""
        return [(v + 1) % Q if i % 3 == 2 else v for i, v in enumerate(rows)]

    def mul(ks):
        return [hm.secp_mul(a, hm.SECP_G) for a in ks]

    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    L = lambda vals: _limbs12(_tile(vals, n))  # noqa: E731
    PT = lambda pts: Pts(tuple(_tile(pts, n)))  # noqa: E731
    C = lambda pts: np.stack([_comp(p) for p in _tile(pts, n)])  # noqa: E731
    idx = np.full((n, 1), 1, np.uint8)
    idx_b = bytes([1])

    # MtA limb glue
    e7, m7 = (_limbs7(_tile([int.from_bytes(rng.bytes(32), "little") for _ in range(k)], n),
                      E_LIMBS) for _ in range(2))
    add7 = _limbs7(_tile([int.from_bytes(rng.bytes(128), "little") >> 1 for _ in range(k)], n),
                   S1_LIMBS)
    bits = rng.integers(0, 2, (n, 256), dtype=np.int32)
    wide = u8(2, n, 40)
    wide[0, 0] = 0xFF  # 2^320 - 1

    # Γ and its commitment, the Schnorr PoK (row 1 claims another Γ)
    gamma, kpok = scal(), scal()
    Gam = mul(gamma)
    blind = u8(n, 32)
    g_commit = np.stack([np.frombuffer(_h(b"gamma", idx_b, blind[i], _comp(Gam[i % k])),
                                       np.uint8) for i in range(n)])
    g_commit_bad = g_commit.copy()
    g_commit_bad[2::3, 0] ^= 1
    A_comp = [_comp(p) for p in mul(kpok)]
    s_pok = [(a - _e(b"schnorr", idx_b, A_comp[i], _comp(Gam[i])) * g) % Q
             for i, (a, g) in enumerate(zip(kpok, gamma))]
    gam_claimed = [Gam[0] if i == 1 else p for i, p in enumerate(Gam)]

    # R = δ⁻¹·ΣΓ (a zero δ on row 1)
    delta = scal()
    if k > 1:
        delta[1] = 0

    # phase 5: V_i = s·R + l·G, A_i = ρ·G, the Pedersen PoK of (s, l)
    s_i, l_i, rho, ka, kb = scal(), scal(), scal(), scal(), scal()
    R_pts = mul(scal())
    V = [hm.secp_add(hm.secp_mul(s, R), hm.secp_mul(l, hm.SECP_G))
         for s, l, R in zip(s_i, l_i, R_pts)]
    A = mul(rho)
    vc, ac = C(V), C(A)
    va_blind = u8(n, 32)
    va_commit = np.stack([np.frombuffer(_h(b"VA", idx_b, va_blind[i], vc[i], ac[i]), np.uint8)
                          for i in range(n)])
    va_commit_bad = va_commit.copy()
    va_commit_bad[2::3, 0] ^= 1
    Apok = [hm.secp_add(hm.secp_mul(a, R), hm.secp_mul(b, hm.SECP_G))
            for a, b, R in zip(ka, kb, R_pts)]
    Apok_comp = [_comp(p) for p in Apok]
    e5 = [_e(b"pedersen", idx_b, Apok_comp[i], vc[i], ac[i]) for i in range(k)]
    sa = [(a - e * s) % Q for a, e, s in zip(ka, e5, s_i)]
    sb = [(b - e * l) % Q for b, e, l in zip(kb, e5, l_i)]
    ut_blind = u8(n, 32)
    U, T = mul(scal()), mul(scal())
    uc, tc = C(U), C(T)
    ut_commit = np.stack([np.frombuffer(_h(b"UT", idx_b, ut_blind[i], uc[i], tc[i]), np.uint8)
                          for i in range(n)])
    ut_commit[2::3, 0] ^= 1

    # W_j from VSS commitments (t + 1 = 2), λ shared by the batch
    lam = int.from_bytes(rng.bytes(32), "big") % Q
    lam_bits = np.array([(lam >> i) & 1 for i in range(256)], np.int32)
    C_comp = np.stack([C(mul(scal())), C(mul(scal()))])

    # ECDSA signatures for the final check: low s on even rows, high on odd
    x, kk, m = scal(), scal(), scal()
    Y = mul(x)
    Rk = mul(kk)
    r = [p.x % Q for p in Rk]
    s_sig = [pow(c, -1, Q) * (mm + rr * xx) % Q for c, mm, rr, xx in zip(kk, m, r, x)]
    s_sig = [min(s, Q - s) if i % 2 == 0 else max(s, Q - s) for i, s in enumerate(s_sig)]
    rec = np.array(_tile([(p.y & 1) | (2 if p.x >= Q else 0) for p in Rk], n), np.int32)
    s_sig = _tile(bad(s_sig), n)
    ok_in = np.arange(n) % 5 != 4

    # the MtA with-check: s1·G = U + e·W
    u_, w_, e_ = scal(), scal(), scal()
    s1 = bad([(a + b * c) % Q for a, b, c in zip(u_, e_, w_)])

    return [
        ("_int_mul_add", (e7, m7, add7, Prof(7, S1_LIMBS))),
        ("_bits_pack", (bits, Prof(7, RAND_LIMBS))),
        ("_scalar_from_wide_bytes", (wide,)),
        ("_base_mul_compressed", (L(gamma),)),
        ("_mod_q_from_limbs", (add7, Prof(7, S1_LIMBS))),
        ("_blk_gamma", (L(gamma), blind, idx)),
        ("_blk_gamma_check", (blind, C(Gam), idx, g_commit_bad)),
        ("_blk_point_add", (PT(Gam), PT([Gam[0]] + A[1:]))),
        ("_blk_point_eq", (PT(V), PT([V[0]] + A[1:]))),
        ("_blk_R", (L(delta), PT(Gam))),
        ("_blk_schnorr", (L(kpok), L(gamma), PT(gam_claimed), C(Gam), idx)),
        ("_blk_schnorr_prove", (L(kpok), L(gamma), C(Gam), idx)),
        ("_blk_schnorr_verify", (np.stack(_tile(A_comp, n)), L(bad(s_pok)), PT(Gam), C(Gam),
                                 idx)),
        ("_blk_pedersen_prove", (L(ka), L(kb), L(s_i), L(l_i), PT(R_pts), vc, ac, idx)),
        ("_blk_pedersen_verify", (np.stack(_tile(Apok_comp, n)), L(sa), L(bad(sb)), PT(V),
                                  PT(R_pts), vc, ac, idx)),
        ("_blk_va_check", (va_blind, vc, ac, idx, va_commit_bad)),
        ("_blk_W_from_vss", (C_comp, 2, lam_bits)),
        ("_blk_va", (L(m), L(r), L(kk), L(x), L(l_i), L(rho), PT(R_pts), va_blind, idx)),
        ("_blk_pedersen", (L(ka), L(kb), L(s_i), L(bad(l_i)), PT(V), PT(R_pts), vc, ac,
                           va_blind, idx, va_commit_bad)),
        ("_blk_V", (PT(V), L(m), L(r), PT(Y))),
        ("_blk_ut", (L(rho), L(l_i), PT(V), PT(A), ut_blind, idx)),
        ("_blk_ut_check", (ut_blind, uc, tc, idx, ut_commit)),
        ("_blk_final", (_limbs12(s_sig), L(m), L(r), PT(Y), rec)),
        ("_withcheck_curve", (L(s1), L(e_), PT(mul(u_)), PT(mul(w_)))),
        ("_step_final", ({"s": _limbs12(s_sig), "m": L(m), "r": L(r), "rec": rec, "ok": ok_in},
                         PT(Y))),
    ]


def to_args(args, pkg: Pkg):
    """The numpy args of :func:`calls` (dicts, profiles, points, ints
    included) → the package's."""
    if isinstance(args, dict):
        return {key: to_args(v, pkg) for key, v in args.items()}
    if isinstance(args, tuple):
        return tuple(to_args(a, pkg) for a in args)
    if isinstance(args, Prof):
        return pkg.prof(args.bits, args.n_limbs)
    if isinstance(args, Pts):
        return pkg.points(list(args.points))
    if isinstance(args, int):
        return args
    return pkg.array(np.asarray(args))


def _is_point(x) -> bool:
    return isinstance(x, tuple) and getattr(type(x), "_fields", None) == ("X", "Y", "Z")


def encode(out, pkg: Pkg) -> List[Dict]:
    """A function's outputs, in order (a dict by sorted key), each as
    {dtype, shape, hex}; a point batch as its affine x ‖ y, 64
    big-endian bytes a row (zeros for the identity)."""
    if isinstance(out, dict):
        return [e for key in sorted(out) for e in encode(out[key], pkg)]
    if _is_point(out):
        rows = b"".join(bytes(64) if p.is_infinity else
                        p.x.to_bytes(32, "big") + p.y.to_bytes(32, "big")
                        for p in pkg.to_host(out))
        return [{"dtype": "point", "shape": list(host(out.X).shape[:-1]), "hex": rows.hex()}]
    if isinstance(out, (tuple, list)):
        return [e for o in out for e in encode(o, pkg)]
    a = np.ascontiguousarray(host(out))
    return [{"dtype": str(a.dtype), "shape": list(a.shape), "hex": a.tobytes().hex()}]


def record(fns: Dict[str, Callable], pkg: Pkg, n: int = B,
           seed: int = SEED) -> Dict[str, List[Dict]]:
    """Every output of :func:`calls` through ``fns[name]`` → {name:
    [{dtype, shape, hex}, ...]}."""
    return {name: encode(fns[name](*to_args(args, pkg)), pkg) for name, args in calls(n, seed)}


def port_pkg(device) -> Pkg:
    """The port's :class:`Pkg` on ``device``."""
    import torch

    from ..core import bignum as bn
    from ..core import secp256k1 as sp

    return Pkg(array=lambda a: torch.as_tensor(np.array(a), device=device),
               prof=lambda bits, n: bn.LimbProfile(bits=bits, n_limbs=n),
               points=lambda pts: sp.from_host(pts, device), to_host=sp.to_host)


def port_fns() -> Dict[str, Callable]:
    from ..engine import gg18_batch as gb

    return {name: getattr(gb, name) for name in FUNCTIONS}
