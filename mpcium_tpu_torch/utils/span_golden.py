"""The engines' phase spans, in a canonical JSON form.

What two implementations must agree on when the same engine call runs
with tracing on: the spans it emits — ``phase:<name>`` per protocol
phase and cohort, ``host:<label>`` per pipeline host stage — their
count, track (``tid``), node and kind, how they nest (trace and parent
ids: under the caller's open span, or the id derived from a public
name), the keys of their attributes (numeric and not), the values of
the structural ones (``cohort``, ``chunks``), and the keys of the
``phase_times`` dict where the engine takes one. Times are not compared,
and the JAX package's ``compile:*`` spans (its compile ledger; the port
compiles no executable per shape) are left out.

Every function takes the modules under test (the JAX package's or the
port's engine and its ``utils.tracing``), so one record format serves
the JAX package on the CPU, the port on the CPU and the port on the
card.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from .rng import SeededStream

UNIVERSE = ["node0", "node1", "node2"]
QUORUM = ["node0", "node1"]
THRESHOLD = 1
OUTER = "golden-call"  # the caller's span around each engine call
ENGINES = ("gg18.sign", "eddsa.sign", "dkg.run", "reshare.run")
STRUCTURAL_ATTRS = ("cohort", "chunks")
# (B, cohorts, keygen seed, sign seed, message seed) per case
EDDSA = {"eddsa_b4_c1": (4, 1, 1301, 1302, 1303), "eddsa_b4_c2": (4, 2, 1301, 1302, 1303)}
GG18_OT = {"gg18_ot_b4_c2": (4, 2, 1401, 1402, 1403)}
GG18_PAILLIER = {"gg18_paillier_b2_c1": (2, 1, 1501, 1502, 1503)}
# the 1024-bit key fixture carries only shrunk exponent domains
PAILLIER_DOMAINS = {"alpha": 600, "beta_prime": 320, "gamma_bob": 600}
# ed25519 DKG of 4 wallets at two cohorts, then a 2-of-3 -> 3-of-5 reshare
DKG = {"dkg_ed25519_b4_c2": (4, 2, 1601), "reshare_ed25519_b4_c1": (4, 1, 1611)}
NEW_COMMITTEE = ["node0", "node1", "node2", "node3", "node4"]


def canonical(spans: List[dict], tracing) -> Dict:
    """Spans → their canonical rows, sorted, plus each engine track's
    phase names in emission order. ``tracing`` supplies ``trace_id_for``."""
    outer = next(s for s in spans if s["name"] == OUTER)
    named = {tracing.trace_id_for(n): n for n in ENGINES + tuple(s["name"] for s in spans)}

    def trace(tid_):
        if tid_ == outer["trace_id"]:
            return "outer"
        return f"name:{named[tid_]}" if tid_ in named else "other"

    def parent(pid):
        if pid is None:
            return None
        return "outer" if pid == outer["span_id"] else "other"

    rows, order = [], {}
    for s in spans:
        if not (s["name"] == OUTER or s["name"].startswith(("phase:", "host:"))):
            continue
        attrs = s.get("attrs") or {}
        numeric = sorted(k for k, v in attrs.items()
                         if isinstance(v, (int, float)) and not isinstance(v, bool))
        rows.append([
            s["tid"], s["name"], s["node"], s["kind"], trace(s["trace_id"]),
            parent(s["parent_id"]), numeric, sorted(set(attrs) - set(numeric)),
            {k: attrs[k] for k in STRUCTURAL_ATTRS if k in attrs},
        ])
        if s["name"].startswith("phase:"):
            order.setdefault(s["tid"], []).append(s["name"])
    rows.sort(key=repr)
    return {"spans": rows, "order": order}


def traced(tracing, call: Callable) -> List[dict]:
    """Run ``call()`` under tracing, inside the caller's span OUTER, and
    return every span it emitted (OUTER last)."""
    spans: List[dict] = []
    tracing.enable(sink=spans.append)
    try:
        with tracing.span(OUTER):
            call()
    finally:
        tracing.disable()
    return spans


def _messages(n: int, seed: int) -> List[bytes]:
    return [r.tobytes() for r in np.random.default_rng(seed).integers(0, 256, (n, 32), np.uint8)]


def _digests(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 32), np.uint8)


def eddsa_record(eb, tracing, case: str, **kw) -> Dict:
    B, cohorts, kseed, sseed, mseed = EDDSA[case]
    shares = eb.dealer_keygen_batch(B, UNIVERSE, THRESHOLD, rng=SeededStream(kseed))
    signer = eb.BatchedCoSigners(QUORUM, [shares[UNIVERSE.index(p)] for p in QUORUM],
                                 rng=SeededStream(sseed), **kw)
    out = {}
    spans = traced(tracing, lambda: out.update(sig=signer.sign(_messages(B, mseed),
                                                               cohorts=cohorts)))
    return {"ok": [bool(v) for v in np.asarray(out["sig"][1])], **canonical(spans, tracing)}


def _gg18_record(gb, tracing, B: int, cohorts: int, signer, dseed: int) -> Dict:
    phases: dict = {}
    out = {}
    spans = traced(tracing, lambda: out.update(
        sig=signer.sign(_digests(B, dseed), phase_times=phases, cohorts=cohorts)))
    return {"ok": [bool(v) for v in np.asarray(out["sig"]["ok"])],
            "phase_times_keys": sorted(phases), **canonical(spans, tracing)}


def gg18_ot_record(gb, tracing, case: str, **kw) -> Dict:
    B, cohorts, kseed, sseed, dseed = GG18_OT[case]
    shares = gb.dealer_keygen_secp_batch(B, UNIVERSE, THRESHOLD, rng=SeededStream(kseed))
    signer = gb.GG18BatchCoSigners(QUORUM, [shares[UNIVERSE.index(p)] for p in QUORUM], None,
                                   rng=SeededStream(sseed), mta_impl="ot", **kw)
    return _gg18_record(gb, tracing, B, cohorts, signer, dseed)


def gg18_paillier_record(gb, tracing, preparams_1024, case: str, **kw) -> Dict:
    B, cohorts, kseed, sseed, dseed = GG18_PAILLIER[case]
    shares = gb.dealer_keygen_secp_batch(B, UNIVERSE, THRESHOLD, rng=SeededStream(kseed))
    signer = gb.GG18BatchCoSigners(
        QUORUM, [shares[UNIVERSE.index(p)] for p in QUORUM], preparams_1024,
        dom=gb.Domains(**PAILLIER_DOMAINS), rng=SeededStream(sseed), mta_impl="paillier", **kw)
    return _gg18_record(gb, tracing, B, cohorts, signer, dseed)


def dkg_record(dkg, tracing, case: str, **kw) -> Dict:
    """``dkg``: the module holding ``BatchedDKG`` and ``BatchedReshare``.
    A reshare case reshares a DKG of its own seed (untraced)."""
    B, cohorts, seed = DKG[case]

    def make():
        return dkg.BatchedDKG(UNIVERSE, THRESHOLD, "ed25519", rng=SeededStream(seed), **kw)

    if case.startswith("dkg"):
        spans = traced(tracing, lambda: make().run(B, cohorts=cohorts))
    else:
        old = make().run(B, cohorts=1)[:2]
        rs = dkg.BatchedReshare(QUORUM, old, NEW_COMMITTEE, 2, rng=SeededStream(seed + 1), **kw)
        spans = traced(tracing, lambda: rs.run(cohorts=cohorts))
    return canonical(spans, tracing)
