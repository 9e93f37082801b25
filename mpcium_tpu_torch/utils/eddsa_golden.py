"""Records of the EdDSA slice, in JSON form.

What two implementations must agree on for the same shares, messages
and seeded stream: the Ed25519 edge table (decode ok masks, encodings
round-tripped through decode and encode, fixed- and variable-base
products at the edge scalars), the batched engine's signatures and ok
masks at two cohort counts plus ``fused_sign_step``'s output, and the
batched party's wire messages and results. Every function takes the
module or class under test (the JAX package's or the port's) and a
``to_dev`` function that turns numpy arrays into that module's arrays,
so one record format serves the JAX package on the CPU, the port on the
CPU and the port on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ..core import hostmath as hm
from .ot_golden import host
from .rng import SeededStream

UNIVERSE = ["node0", "node1", "node2"]
QUORUM = ["node0", "node1"]
THRESHOLD = 1
B = 4
ENGINE = {"keygen": 501, "sign": 502, "messages": 503, "fused": 504, "cohorts": [1, 2]}
PARTY = {"keygen": 601, "messages": 603, "party": 610, "cohorts": 2,
         "session": "eddsa-golden-b4"}

_P = hm.ED_P
# the scalars that stress a ladder's ends: 0, 1, l - 1, l and the widest
EDGE_SCALARS = [0, 1, hm.ED_L - 1, hm.ED_L, (1 << 256) - 1, 0x1234567 << 200]


def _enc(y: int, sign: int = 0) -> bytes:
    return (y | (sign << 255)).to_bytes(32, "little")


def _non_residue_ys(n: int) -> List[int]:
    """The first n y whose x² = (y² - 1)/(d·y² + 1) has no square root."""
    out, y = [], 2
    while len(out) < n:
        if hm._ed_recover_x(y, 0) is None:
            out.append(y)
        y += 1
    return out


def edge_encodings() -> List[bytes]:
    """Encodings that decide ok masks: every y ≥ p (19 values) and its
    sign-bit twin, non-residue x², x = 0 with the sign bit set (y = 1,
    y = p - 1), and valid points — the base point, the identity, the
    order-2 point, the order-4 points (y = 0) and a few multiples of B."""
    out = [_enc(_P + i, s) for i in range(19) for s in (0, 1)]
    out += [_enc(y, s) for y in _non_residue_ys(2) for s in (0, 1)]
    out += [_enc(1, 1), _enc(_P - 1, 1), _enc(1), _enc(_P - 1), _enc(0), _enc(0, 1)]
    out += [hm.ed_compress(hm.ed_mul(k, hm.ED_B)) for k in (1, 2, 7, hm.ED_L - 1)]
    return out


def _scalar_bases() -> List[bytes]:
    """Bases of the variable-base edge rows: 7·B and an order-4 point
    (a torsion component, where an unreduced scalar shows)."""
    return [hm.ed_compress(hm.ed_mul(7, hm.ED_B)), _enc(0)]


def edges_record(ed, to_dev: Callable) -> Dict:
    enc = np.stack([np.frombuffer(e, np.uint8) for e in edge_encodings()])
    pts, ok = ed.decompress(to_dev(enc))
    bits = ed.scalars_to_bits(EDGE_SCALARS)
    bases = [b for b in _scalar_bases() for _ in EDGE_SCALARS]
    bpts, bok = ed.decompress(
        to_dev(np.stack([np.frombuffer(b, np.uint8) for b in bases]))
    )
    rows = [r.tobytes().hex() for r in host(ed.compress(pts))]
    return {
        "encodings": [e.hex() for e in edge_encodings()],
        "decompress_ok": [bool(v) for v in host(ok)],
        "roundtrip": rows,
        "scalars": [hex(k) for k in EDGE_SCALARS],
        "base_mul": [r.tobytes().hex() for r in host(ed.compress(ed.base_mul(to_dev(bits))))],
        "scalar_bases_ok": [bool(v) for v in host(bok)],
        "scalar_mul": [
            r.tobytes().hex()
            for r in host(ed.compress(ed.scalar_mul(to_dev(np.tile(bits, (2, 1))), bpts)))
        ],
    }


def messages(n: int, seed: int) -> List[bytes]:
    rows = np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)
    return [r.tobytes() for r in rows]


def engine_record(eb, to_dev: Callable, **signer_kw) -> Dict:
    """Signatures and ok masks of ``eb.BatchedCoSigners`` at each cohort
    count of ENGINE, and ``eb.fused_sign_step`` on seeded r64 / c64 with
    the same signer's λ·x limbs."""
    shares = eb.dealer_keygen_batch(B, UNIVERSE, THRESHOLD, rng=SeededStream(ENGINE["keygen"]))
    quorum = [shares[UNIVERSE.index(p)] for p in QUORUM]
    msgs = messages(B, ENGINE["messages"])
    rec = {"public_keys": [s.public_key.hex() for s in shares[0]],
           "messages": [m.hex() for m in msgs], "cohorts": {}}
    for k in ENGINE["cohorts"]:
        signer = eb.BatchedCoSigners(QUORUM, quorum, rng=SeededStream(ENGINE["sign"]),
                                     **signer_kw)
        sigs, ok = signer.sign(msgs, cohorts=k)
        rec["cohorts"][str(k)] = {"signatures": [bytes(r).hex() for r in host(sigs)],
                                  "ok": [bool(v) for v in host(ok)]}
    frng = np.random.default_rng(ENGINE["fused"])
    r64 = frng.integers(0, 256, (len(QUORUM), B, 64), dtype=np.uint8)
    c64 = frng.integers(0, 256, (B, 64), dtype=np.uint8)
    sigs, ok_R = eb.fused_sign_step(to_dev(r64), to_dev(c64), to_dev(signer.lamx))
    rec["fused"] = {"signatures": [bytes(r).hex() for r in host(sigs)],
                    "ok_R": [bool(v) for v in host(ok_R)]}
    return rec


def party_record(eb, party_cls, run_protocol, **party_kw) -> Dict:
    """Every wire message (in the runner's order) and each party's
    result of a B-wallet batch signed by the QUORUM parties of a 2-of-3
    universe, each with its own seeded stream."""
    shares = eb.dealer_keygen_batch(B, UNIVERSE, THRESHOLD, rng=SeededStream(PARTY["keygen"]))
    msgs = messages(B, PARTY["messages"])
    wire: List = []

    def recorded(fn):
        def call(*args):
            out = fn(*args)
            wire.extend([m.round, m.from_id, m.to, dict(m.payload)] for m in out)
            return out

        return call

    parties = {}
    for i, pid in enumerate(QUORUM):
        p = party_cls(PARTY["session"], pid, QUORUM, shares[UNIVERSE.index(pid)], msgs,
                      rng=SeededStream(PARTY["party"] + i), cohorts=PARTY["cohorts"],
                      **party_kw)
        p.start, p.receive = recorded(p.start), recorded(p.receive)
        parties[pid] = p
    run_protocol(parties)
    return {
        "public_keys": [s.public_key.hex() for s in shares[0]],
        "messages": [m.hex() for m in msgs],
        "wire": wire,
        "results": {
            pid: {"signatures": [bytes(r).hex() for r in host(p.result["signatures"])],
                  "ok": [bool(v) for v in host(p.result["ok"])]}
            for pid, p in parties.items()
        },
    }
