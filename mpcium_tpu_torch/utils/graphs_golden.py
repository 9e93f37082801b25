"""Seeded calls of the EdDSA engine's graphed functions, and their record.

The engine's nine jitted functions of the JAX package and the jitted
SHA-512 of its challenge are ``engine.graphs.graphed`` in the port
(``engine/eddsa_batch``). :func:`calls` builds one call of each at a
batch of B sessions and a quorum of q from a numpy seed, with meaningful
inputs: RFC 8032 signatures (one with a wrong challenge) for the
verifier, compressed nonce points (one invalid encoding) for the
aggregation, commitments that match their messages for the fraud check.
:func:`record` runs them through a module's functions and writes every
output's bytes. One record format serves the JAX package on the CPU
(the committed golden ``graphs_b2.json``), the port on the CPU (plain
bodies, or replays through a stand-in capture) and the port on the card
(replays against the eager bodies, ``chip_smoke.py`` phase 35).
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..core import bignum as bn
from ..core import hostmath as hm
from ..engine.eddsa_batch import COMMIT_PREFIX
from .ot_golden import host

FUNCTIONS = ("nonce_commitments", "aggregate_nonce", "partial_signature",
             "combine_signatures", "verify_signatures", "fused_sign_step",
             "round_step_nonce", "round_step_aggregate", "round_step_partial", "sha512")
B, Q, SEED = 2, 2, 701
_DISTINCT = 8  # signatures and points made on the host; larger batches tile them


def _scalars(rng, shape) -> np.ndarray:
    """Uniform scalars mod l as int32 limbs of ``shape`` + (22,)."""
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % hm.ED_L for _ in range(n)]
    return bn.batch_to_limbs(vals, bn.P256).reshape(tuple(shape) + (bn.P256.n_limbs,))


def _tile(rows: np.ndarray, n: int) -> np.ndarray:
    return np.resize(rows, (n,) + rows.shape[1:])


def _signed(rng, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """n RFC 8032 rows (sig, A, c64); the last row's challenge is another
    message's (it must not verify)."""
    k = min(n, _DISTINCT)
    seeds = [rng.bytes(32) for _ in range(k)]
    msgs = [rng.bytes(32) for _ in range(k)]
    sigs = np.stack([np.frombuffer(hm.ed25519_sign_plain(s, m), np.uint8)
                     for s, m in zip(seeds, msgs)])
    pubs = np.stack([np.frombuffer(hm.ed25519_public_from_seed(s), np.uint8) for s in seeds])
    c64 = np.stack([np.frombuffer(hashlib.sha512(s[:32].tobytes() + a.tobytes() + m).digest(),
                                  np.uint8) for s, a, m in zip(sigs, pubs, msgs)])
    sigs, pubs, c64 = (_tile(x, n) for x in (sigs, pubs, c64))
    if n > 1:
        c64[-1] = c64[0]
    return sigs, pubs, c64


def _points(rng, q: int, n: int) -> np.ndarray:
    """(q, n, 32) compressed k·B for seeded k; the last row of the last
    party is an invalid encoding (y = 2^255 - 1 ≥ p)."""
    k = min(n, _DISTINCT)
    rows = np.stack([np.stack([np.frombuffer(hm.ed_compress(hm.ed_mul(
        int.from_bytes(rng.bytes(8), "little") + 1, hm.ED_B)), np.uint8) for _ in range(k)])
        for _ in range(q)])
    out = np.stack([_tile(r, n) for r in rows])
    out[-1, -1] = 0xFF
    out[-1, -1, 31] = 0x7F
    return out


def calls(n: int = B, q: int = Q, seed: int = SEED) -> List[Tuple[str, tuple]]:
    """One seeded call of each of :data:`FUNCTIONS` at B = ``n``: (name,
    numpy args); the round steps' state dicts hold numpy arrays too."""
    rng = np.random.default_rng(seed)
    u8 = lambda *shape: rng.integers(0, 256, shape, dtype=np.uint8)  # noqa: E731
    r64, blinds, c64 = u8(q, n, 64), u8(q, n, 32), u8(n, 64)
    r64[0, 0] = 0xFF  # 2^512 - 1
    lamx, r, parts = _scalars(rng, (q, n)), _scalars(rng, (q, n)), _scalars(rng, (q, n))
    R_all = _points(rng, q, n)
    sig, A, c_ok = _signed(rng, n)
    pref = np.frombuffer(COMMIT_PREFIX, np.uint8).copy()
    commit_msg = u8(q, n, len(COMMIT_PREFIX) + 64)
    commits = np.stack([[np.frombuffer(hashlib.sha256(m.tobytes()).digest(), np.uint8)
                         for m in row] for row in commit_msg])
    ok_R = np.arange(n) % 3 != 2
    return [
        ("nonce_commitments", (r64,)),
        ("aggregate_nonce", (R_all,)),
        ("partial_signature", (r, np.broadcast_to(c64, (q,) + c64.shape), lamx)),
        ("combine_signatures", (parts, u8(n, 32))),
        ("verify_signatures", (sig, A, c_ok)),
        ("fused_sign_step", (r64, c64, lamx)),
        ("round_step_nonce", ({"r64": r64, "blinds": blinds}, pref)),
        ("round_step_aggregate", ({"r": r, "R_comp": R_all, "commit_msg": commit_msg,
                                   "commits": commits},)),
        ("round_step_partial", ({"r": r, "R_sum": u8(n, 32), "ok_R": ok_R,
                                 "fraud_free": np.bool_(True)}, c64, lamx)),
        ("sha512", (u8(n, 96),)),
    ]


def to_args(args, to_dev: Callable):
    """numpy args (dicts included) → the module's arrays."""
    if isinstance(args, dict):
        return {k: to_dev(np.asarray(v)) for k, v in args.items()}
    if isinstance(args, tuple):
        return tuple(to_args(a, to_dev) for a in args)
    return to_dev(np.asarray(args))


def leaves(out) -> List[np.ndarray]:
    """A function's outputs (array, tuple, or dict by sorted key) as numpy."""
    if isinstance(out, dict):
        return [host(out[k]) for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [host(o) for o in out]
    return [host(out)]


def encode(out) -> List[Dict]:
    return [{"dtype": str(a.dtype), "shape": list(a.shape), "hex": a.tobytes().hex()}
            for a in leaves(out)]


def record(fns: Dict[str, Callable], to_dev: Callable, n: int = B, q: int = Q,
           seed: int = SEED) -> Dict[str, List[Dict]]:
    """Every output of :func:`calls` through ``fns[name]`` → {name:
    [{dtype, shape, hex}, ...]}."""
    return {name: encode(fns[name](*to_args(args, to_dev)))
            for name, args in calls(n, q, seed)}
