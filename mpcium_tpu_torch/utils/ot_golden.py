"""Wire records of one OT-MtA leg, in JSON form.

What two implementations of a leg must agree on for the same base-OT
keys, inputs and random stream: the three-round wire messages (U, the
KOS tags, y0/y1 per payload set, the Gilboa and consistency openings),
both parties' shares and the check verdicts, and the same for
``run_multi`` at a given chunk count (its per-chunk transcript
concatenated). Large tensors are recorded by shape and SHA-256 digest,
small ones in full. The functions take any leg object with the
``OTMtALeg`` surface and a ``limbs`` function that turns python ints
into that leg's scalar tensors, so one record format serves the JAX
leg, the port on the CPU and the port on the card.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..core import bignum as bn
from ..core.hostmath import SECP_N as Q
from .rng import DetRng

KAPPA = 128
SYNTH_SEED = 1
INPUTS_SEED = 13


def synth_base_ot(seed: int = SYNTH_SEED) -> Tuple[bytes, np.ndarray, np.ndarray, np.ndarray]:
    """(tag, k0, k1, delta) of a leg built from the base OTs'
    postcondition, as ``tests/test_tamper_checks.py`` builds it."""
    rng = DetRng(seed)
    k0 = np.frombuffer(rng.token_bytes(KAPPA * 32), np.uint8).reshape(-1, 32).copy()
    k1 = np.frombuffer(rng.token_bytes(KAPPA * 32), np.uint8).reshape(-1, 32).copy()
    delta = np.frombuffer(rng.token_bytes(KAPPA), np.uint8) & 1
    return b"t-advs|%d" % seed, k0, k1, delta


def leg_inputs(B: int, seed: int = INPUTS_SEED) -> Tuple[List[int], List[int], List[int]]:
    """Alice's a and Bob's γ, w: a[0] = 0, Bob's scalars non-zero (b = 0
    makes B = b·G the identity, whose encoding the openings reject)."""
    r = DetRng(seed)
    a = [r.randbelow(Q) for _ in range(B)]
    g = [r.randbelow(Q - 1) + 1 for _ in range(B)]
    w = [r.randbelow(Q - 1) + 1 for _ in range(B)]
    a[0] = 0
    return a, g, w


def host(x) -> np.ndarray:
    """A device tensor (torch or JAX) or array → numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def digest(x) -> Dict:
    arr = np.ascontiguousarray(host(x))
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def rows_hex(x) -> List[str]:
    return [bytes(r).hex() for r in host(x).reshape(host(x).shape[0], -1)]


def scalars_hex(x) -> List[str]:
    return ["%064x" % v for v in bn.batch_from_limbs(host(x).astype(np.int32), bn.P256)]


def _verdicts(leg) -> Dict:
    v = leg.check_verdicts or {}
    return {k: host(a).astype(bool).tolist() for k, a in sorted(v.items())}


def wire_record(leg, limbs: Callable, a: Sequence[int], bs: Sequence[Sequence[int]],
                ctr: int = 0) -> Dict:
    """The three-round composition at extension counter ``ctr``."""
    msg_a = leg.alice_round1(limbs(a), ctr)
    msgs_b, betas = leg.bob_round2_multi(tuple(limbs(b) for b in bs), msg_a, ctr)
    alphas = leg.alice_round3_multi(msgs_b)
    rec = {"U": digest(msg_a["U"])}
    if "kos_xbar" in msg_a:
        rec["kos_xbar"] = rows_hex(msg_a["kos_xbar"])
        rec["kos_tbar"] = digest(msg_a["kos_tbar"])
    rec["sets"] = [
        {k: (digest(m[k]) if k in ("y0", "y1") else rows_hex(m[k]))
         for k in ("y0", "y1", "D", "B_pt", "Beta_pt") if k in m}
        for m in msgs_b
    ]
    rec["alpha"] = [scalars_hex(x) for x in alphas]
    rec["beta"] = [scalars_hex(x) for x in betas]
    rec["verdicts"] = _verdicts(leg)
    return rec


def run_multi_record(leg, limbs: Callable, a: Sequence[int],
                     bs: Sequence[Sequence[int]], chunks: int) -> Dict:
    """``run_multi`` at ``chunks``: the transcript's U, y0, y1
    (concatenated over chunks), the shares and the verdicts."""
    tr: list = []
    out = leg.run_multi(limbs(a), tuple(limbs(b) for b in bs), chunks=chunks, transcript=tr)
    S = len(bs)
    return {
        "chunks": len(tr),
        "U": digest(np.concatenate([host(t["U"]) for t in tr], axis=1)),
        "y0": [digest(np.concatenate([host(t["y0"][s]) for t in tr])) for s in range(S)],
        "y1": [digest(np.concatenate([host(t["y1"][s]) for t in tr])) for s in range(S)],
        "alpha": [scalars_hex(al) for al, _be in out],
        "beta": [scalars_hex(be) for _al, be in out],
        "verdicts": _verdicts(leg),
    }


def leg_record(make_leg: Callable, limbs: Callable, B: int, chunks=(1, 2)) -> Dict:
    """The whole record of a fresh synthetic leg per run: the wire
    composition, then ``run_multi`` at each chunk count."""
    a, g, w = leg_inputs(B)
    rec = {"B": B, "synth_seed": SYNTH_SEED, "inputs_seed": INPUTS_SEED,
           "wire": wire_record(make_leg(), limbs, a, (g, w))}
    rec["run_multi"] = {str(k): run_multi_record(make_leg(), limbs, a, (g, w), k)
                        for k in chunks}
    return rec


# Every wire field an active cheater controls, the payload set it lives
# in, and the (party, check) that must be blamed for corrupting it (the
# table of tests/test_tamper_checks.py). Case i corrupts lane i % B.
TAMPER_CASES = [
    ("U", None, "alice", "kos"),
    ("kos_xbar", None, "alice", "kos"),
    ("kos_tbar", None, "alice", "kos"),
    ("y0", 0, "bob", "gilboa"),
    ("y1", 1, "bob", "gilboa"),
    ("D", 0, "bob", "gilboa"),
    ("B_pt", 1, "bob", "gilboa"),
    ("Beta_pt", 0, "bob", "consistency"),
]


def tamper_run(leg, limbs: Callable, B: int, case: int):
    """Run TAMPER_CASES[case] on ``leg`` (byte 7 of the lane's slice,
    xor 0x40) → (lane, blame per lane, verdicts as lists)."""
    field, set_idx, _party, _check = TAMPER_CASES[case]
    lane = case % B
    a, g, w = leg_inputs(B)
    spec = {"field": field, "lane": lane, "byte": 7, "xor": 0x40}
    if set_idx is not None:
        spec["set"] = set_idx
    leg.set_tamper(spec)
    leg.run_multi(limbs(a), (limbs(g), limbs(w)))
    return lane, leg.check_blame(), _verdicts(leg)
