#!/usr/bin/env python
"""Microbench: the host IKNP extension stage, thread-count A/B, over the
port's native library.

The port of ``scripts/bench_ot_host.py``. It times the work the host OT
route (``MPCIUM_OT_DEVICE=0``) hides behind the card: PRG expansion of the
three seed matrices (t0 / t1 / tD), the U / Q xor assembly, the packed
bit-matrix transpose and the per-OT pad hashing for two payload sets, at
M = 2^20 OTs (B = 4096 signing lanes), host code only, over
``mpcium_tpu_torch/native/`` (built by g++ at first use). It runs the
same bytes at MPCIUM_NATIVE_THREADS=1 and =N (the knob is read per native
call), asserts every output equal across thread counts, and prints one
JSON line with the speedup.

``--device [DEV]`` (default the GPU) adds the native-against-card A/B of
each sub-stage (PRG expansion, packed transpose, pad hashing) against
``ops/hash_suite.py`` on DEV, warm, outputs asserted equal to the native
ones before any time is reported, under the ``ot_host_*`` /
``ot_device_*`` keys. ``--device cpu`` runs the torch twins on the CPU.

Usage: python scripts/torch_bench_ot_host.py [--m 1048576] [--threads 4] [--device [DEV]]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpcium_tpu_torch import native  # noqa: E402
from mpcium_tpu_torch.protocol.ecdsa import mta_ot  # noqa: E402

KAPPA = mta_ot.KAPPA
PRG_PREFIX = b"mpcium-ot-prg|"


def _prg(seeds: np.ndarray, n_bytes: int, tag: bytes) -> np.ndarray:
    """(n, 32) seeds → (n, n_bytes) keystream (the JAX package's ``_prg``
    over the native expansion)."""
    out = mta_ot._prg_host(seeds, tag, -(-n_bytes // 32), 0)
    return out[:, :n_bytes] if out.shape[1] != n_bytes else out


def _stage(seeds3, delta, delta_packed, delta_rows, r_packed, M, tag):
    """One host extension stage: PRG ×3, U / Q assembly, transpose + pads
    for two payload sets, both roles. Returns a digest of every output so
    the A/B runs can be asserted equal."""
    k0, k1, kD = seeds3
    n_bytes = M // 8
    t0 = _prg(k0, n_bytes, tag)
    t1 = _prg(k1, n_bytes, tag)
    U = native.xor_rows(t1, t0)  # the t1 buffer becomes U
    native.xor_rows(U, r_packed)
    tD = _prg(kD, n_bytes, tag)
    for r in delta_rows:
        tD[r] ^= U[r]  # the Q matrix, in place
    prefixes = [b"bench-pad|" + tag + b"|s%d" % s for s in range(2)]
    padsA = mta_ot._derive_pads_multi(prefixes, t0, M)
    padsB = mta_ot._derive_pads_multi(prefixes, tD, M, delta=delta_packed)
    acc = np.zeros(32, np.uint64)
    for p in padsA:
        acc += p[:64].astype(np.uint64).sum(axis=0)
    for p0, p1 in padsB:
        acc += p0[:64].astype(np.uint64).sum(axis=0)
        acc += p1[:64].astype(np.uint64).sum(axis=0)
    return U[:, :8].copy(), acc


def _timed(n_runs, *args):
    best = float("inf")
    digest = None
    for _ in range(n_runs):
        t0 = time.perf_counter()
        digest = _stage(*args)
        best = min(best, time.perf_counter() - t0)
    return best, digest


def _best_of(n_runs, fn, sync=None):
    """Best wall of ``n_runs`` calls after one untimed call; ``sync`` waits
    for the device's queue inside each timed call."""
    out = fn()
    if sync:
        sync()
    best = float("inf")
    for _ in range(n_runs):
        t0 = time.perf_counter()
        out = fn()
        if sync:
            sync()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _device_ab(seeds3, M, tag, n_runs, device):
    """Per sub-stage native against ``ops/hash_suite`` on ``device``: PRG,
    transpose, pads. Device outputs are asserted equal to the native
    ones before any time is reported."""
    import torch

    from mpcium_tpu_torch.device import resolve
    from mpcium_tpu_torch.ops import hash_suite as hs

    dev = resolve(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None
    k0 = seeds3[0]
    n_bytes = M // 8
    nblk = -(-n_bytes // 32)
    prg_prefix = PRG_PREFIX + tag
    pad_prefix = b"bench-pad|" + tag + b"|s0"

    # PRG expansion: (KAPPA, 32) seeds → (KAPPA, M/8) keystream
    host_prg_s, t0_host = _best_of(n_runs, lambda: _prg(k0, n_bytes, tag))
    seeds_dev = hs.as_bytes(k0, dev)
    device_prg_s, dev_prg = _best_of(
        n_runs, lambda: hs.prg_expand(prg_prefix, seeds_dev, nblk), sync)
    assert np.array_equal(dev_prg.cpu().numpy()[:, :n_bytes], t0_host), \
        "device PRG diverged from the native PRG"

    # packed bit transpose: (KAPPA, M/8) → (M, KAPPA/8)
    host_transpose_s, rows_host = _best_of(n_runs, lambda: native.ot_transpose(t0_host))
    t0_dev = hs.as_bytes(t0_host, dev)
    device_transpose_s, rows_dev = _best_of(n_runs, lambda: hs.ot_transpose(t0_dev), sync)
    assert np.array_equal(rows_dev.cpu().numpy(), rows_host), \
        "device transpose diverged from the native transpose"

    # pad hashing: H(prefix ‖ row ‖ le32(j)) per OT → (M, 32)
    idx = np.arange(M, dtype="<u4").view(np.uint8).reshape(M, 4)
    buf = np.concatenate([rows_host, idx], axis=1)
    host_pads_s, pads_host = _best_of(n_runs, lambda: native.batch_sha256(pad_prefix, buf))
    rows_in = hs.as_bytes(rows_host, dev)
    device_pads_s, pads_dev = _best_of(
        n_runs, lambda: hs.pad_hash(pad_prefix, rows_in, 0), sync)
    assert np.array_equal(pads_dev.cpu().numpy(), pads_host), \
        "device pads diverged from the native pads"

    host_total = host_prg_s + host_transpose_s + host_pads_s
    dev_total = device_prg_s + device_transpose_s + device_pads_s
    return {
        "device_platform": "gpu" if dev.type == "cuda" else dev.type,
        "ot_host_prg_s": round(host_prg_s, 4),
        "ot_device_prg_s": round(device_prg_s, 4),
        "ot_host_transpose_s": round(host_transpose_s, 4),
        "ot_device_transpose_s": round(device_transpose_s, 4),
        "ot_host_pads_s": round(host_pads_s, 4),
        "ot_device_pads_s": round(device_pads_s, 4),
        "ot_host_stage_s": round(host_total, 4),
        "ot_device_stage_s": round(dev_total, 4),
        "ot_device_stage_speedup": round(host_total / dev_total, 3) if dev_total > 0 else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1 << 20, help="OT count M")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", nargs="?", const="cuda", default=None,
                    help="also A/B each sub-stage against ops/hash_suite on DEV "
                         "(bare: the GPU)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(42)
    seeds3 = tuple(rng.integers(0, 256, size=(KAPPA, 32), dtype=np.uint8) for _ in range(3))
    delta = rng.integers(0, 2, size=KAPPA, dtype=np.uint8)
    delta_packed = np.packbits(delta, bitorder="little")
    delta_rows = np.nonzero(delta)[0]
    r_packed = rng.integers(0, 256, size=args.m // 8, dtype=np.uint8)
    stage_args = (seeds3, delta, delta_packed, delta_rows, r_packed, args.m, b"ab")

    saved = os.environ.get("MPCIUM_NATIVE_THREADS")
    try:
        os.environ["MPCIUM_NATIVE_THREADS"] = "1"
        t_1, d_1 = _timed(args.runs, *stage_args)
        os.environ["MPCIUM_NATIVE_THREADS"] = str(args.threads)
        t_n, d_n = _timed(args.runs, *stage_args)
    finally:
        if saved is None:
            os.environ.pop("MPCIUM_NATIVE_THREADS", None)
        else:
            os.environ["MPCIUM_NATIVE_THREADS"] = saved

    assert np.array_equal(d_1[0], d_n[0]) and np.array_equal(d_1[1], d_n[1]), \
        "the thread count changed the transcript"

    record = {
        "metric": "ot_host_extension_stage_speedup",
        "value": round(t_1 / t_n, 3) if t_n > 0 else 0.0,
        "unit": "x (1 thread / %d threads wall)" % args.threads,
        "m_ots": args.m,
        "threads": args.threads,
        "cores": os.cpu_count(),
        "native": native.available(),
        "stage_s_1thread": round(t_1, 3),
        "stage_s_nthread": round(t_n, 3),
    }
    if args.device:
        record.update(_device_ab(seeds3, args.m, b"ab", args.runs, args.device))
    from mpcium_tpu_torch.perf.envfp import env_fingerprint

    record["env"] = env_fingerprint()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
