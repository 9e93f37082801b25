#!/usr/bin/env python
"""A/B of the counter-phase cohort pipeline on the port's batched Ed25519 engine.

The port of ``scripts/bench_pipeline_cpu.py``. It runs the batched
Ed25519 engine at one batch size under K = 1 (the serial oracle) and each
other cohort count of ``--k``, with the span recorder armed, and writes a
JSON artifact (default ``GPU_BENCH_pipeline_ab.json`` at the repo root):

- signatures must be byte-identical across K (the transcript contract);
- the span-derived ``tracing.device_idle_fraction`` per K, which must be
  strictly lower at K=2 than at K=1 (``--lenient`` reports a miss without
  failing; byte identity always fails hard).

``--device [DEV]`` picks the torch device (bare or absent: the GPU, which
raises when there is none; ``--device cpu`` for the CPU). The random
streams are hash counters with fixed seeds, so every K draws the same
bytes.

Usage: python scripts/torch_bench_pipeline.py [--device cpu] [--b 8] [--k 1,2,4]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _ROOT)

OUT_BASENAME = "GPU_BENCH_pipeline_ab.json"


class DetRng:
    """Hash-counter stand-in for a CSPRNG (the JAX bench's): equal seeds
    draw equal streams, so every K consumes the same nonce and blind bytes."""

    def __init__(self, seed: int):
        self.seed = seed
        self.ctr = 0

    def token_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += hashlib.sha256(b"pipebench|%d|%d" % (self.seed, self.ctr)).digest()
            self.ctr += 1
        return bytes(out[:n])

    def randbelow(self, n: int) -> int:
        return int.from_bytes(self.token_bytes(40), "big") % n


def _one_run(ids, shares, messages, k: int, dev):
    import numpy as np

    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.utils import tracing

    signer = eb.BatchedCoSigners(ids[:2], shares[:2], rng=DetRng(42), device=dev)
    spans: list = []
    tracing.enable(sink=spans.append)
    try:
        t0 = time.perf_counter()
        sigs, ok = signer.sign(messages, cohorts=k)
        wall_s = time.perf_counter() - t0
    finally:
        tracing.disable()
    assert np.asarray(ok).all(), f"K={k} produced invalid signatures"
    return {
        "sig_sha256": hashlib.sha256(np.asarray(sigs).tobytes()).hexdigest(),
        "wall_s": round(wall_s, 4),
        "device_idle_fraction": round(tracing.device_idle_fraction(spans), 6),
        "phase_s": {k2: round(v, 5) for k2, v in tracing.phase_share(spans).items()},
        "n_spans": len(spans),
    }


def _stop_pipe_host() -> None:
    from mpcium_tpu_torch.engine import pipeline

    with pipeline._POOL_LOCK:
        pool, pipeline._HOST_POOL = pipeline._HOST_POOL, None
    if pool is not None:
        pool.shutdown(wait=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--b", type=int, default=8, help="batch size (pow-2)")
    p.add_argument("--k", default="1,2", help="comma list of cohort counts (K=1 always runs)")
    p.add_argument("--device", nargs="?", const=None, default=None,
                   help="torch device (bare or absent: the GPU)")
    p.add_argument("--lenient", action="store_true",
                   help="report but do not fail the idle comparison "
                        "(byte identity stays a hard failure)")
    p.add_argument("--out", default=os.path.join(_ROOT, OUT_BASENAME))
    args = p.parse_args(argv)
    ks = sorted({int(x) for x in args.k.split(",") if x.strip()})
    if 1 not in ks:
        ks.insert(0, 1)  # K=1 is the serial oracle every K compares to

    from mpcium_tpu_torch.device import resolve
    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.perf.envfp import env_fingerprint

    dev = resolve(args.device)  # raises without a GPU unless --device cpu
    B = args.b
    ids = ["n0", "n1", "n2"]
    shares = eb.dealer_keygen_batch(B, ids, 1, rng=DetRng(3))
    messages = [DetRng(9).token_bytes(32) for _ in range(B)]

    try:
        # pay every K's first-use costs outside the measured runs
        for k in ks:
            signer = eb.BatchedCoSigners(ids[:2], shares[:2], rng=DetRng(42), device=dev)
            _sigs, ok = signer.sign(messages, cohorts=k)
            assert ok.all()
        runs = {str(k): _one_run(ids, shares, messages, k, dev) for k in ks}
    finally:
        _stop_pipe_host()

    identical = all(runs[str(k)]["sig_sha256"] == runs["1"]["sig_sha256"] for k in ks)
    idle_1 = runs["1"]["device_idle_fraction"]
    idle_2 = runs["2"]["device_idle_fraction"] if 2 in ks else None
    doc = {
        "comment": (
            "A/B of the counter-phase cohort pipeline on the port's batched "
            "Ed25519 engine: K=1 serial oracle against each other K, spans "
            "armed; signatures byte-identical, span-derived device idle "
            "fraction per K. Regenerate with scripts/torch_bench_pipeline.py."
        ),
        "engine": "eddsa.sign",
        "batch": B,
        "cohorts": ks,
        "runs": runs,
        "signatures_bit_identical": identical,
        "idle_fraction_k1": idle_1,
        "idle_fraction_k2": idle_2,
        "idle_collapse_ratio": (round(idle_2 / idle_1, 4)
                                if idle_1 and idle_2 is not None else None),
        "env": env_fingerprint(),
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
    }
    for k in ks:
        doc[f"idle_fraction_k{k}"] = runs[str(k)]["device_idle_fraction"]
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in doc.items() if k != "comment"}))
    if not identical:
        print("FAIL: signatures differ across K", file=sys.stderr)
        return 1
    if idle_2 is not None and not idle_2 < idle_1:
        verdict = f"K=2 idle {idle_2} not below K=1 idle {idle_1}"
        if not args.lenient:
            print(f"FAIL: {verdict}", file=sys.stderr)
            return 1
        print(f"warn (lenient): {verdict}")
    print(f"ok: idle {idle_1} (K=1) -> {idle_2} (K=2), sigs identical")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
