#!/usr/bin/env python3
"""Time the PyTorch port's batched GG18 sign from several checkouts, in
turns, on one GPU.

    python3 scripts/torch_sign_ab.py [--batch 1024] [--seed 1] DIR [DIR ...]

Each DIR is the root of a checkout that holds ``mpcium_tpu_torch/``
(for example the parent commit unpacked with ``git archive`` into a
git-ignored directory, and ``.``). Each run is a fresh subprocess with
its own import of that checkout's package and its own kernel build, in
the order given, so ``parent . . parent`` compares two versions inside
one call on one card. A run does what chip_smoke.py's slice phase does:
dealer keygen for B wallets, a first sign (it builds the per-key comb
tables and, where the checkout graphs the engine, captures its graphs),
then the warm sign that is timed, with every (r, s) verified on
the host. It prints one JSON line per run: first and warm sign seconds,
sigs/s, the engine's phase seconds, the kernel launches of the warm sign
as the checkout's counters report them, and the card's name and power
limit; where the checkout graphs the GG18 engine, the keys its signs
captured with their capture seconds and pool bytes. Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, subprocess, sys, time
root, B, seed, device = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
sys.path.insert(0, root)
import numpy as np
import torch
from mpcium_tpu_torch.cluster import load_test_preparams
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.engine import gg18_batch as gb
from mpcium_tpu_torch.ops import mulmod as K
from mpcium_tpu_torch.utils.rng import SeededStream

def sync():
    if device == "cuda":
        torch.cuda.synchronize()

shares = gb.dealer_keygen_secp_batch(B, ["node0", "node1", "node2"], threshold=1,
                                     rng=SeededStream(seed))
signer = gb.GG18BatchCoSigners(["node0", "node1"], [shares[0], shares[1]],
                               load_test_preparams(2048), dom=gb.Domains(),
                               rng=SeededStream(seed + 1), device=device)
drng = np.random.default_rng(seed + 2)
t0 = time.perf_counter()
out = signer.sign(drng.integers(0, 256, (B, 32), dtype=np.uint8), cohorts=2)
sync()
first = time.perf_counter() - t0
digests = drng.integers(0, 256, (B, 32), dtype=np.uint8)
phases = {}
K.reset_counters()
t0 = time.perf_counter()
out = signer.sign(digests, phase_times=phases, cohorts=2)
sync()
warm = time.perf_counter() - t0
by_mode = getattr(K, "powmod_launches_by_mode_width", {})
verified = sum(
    hm.ecdsa_verify(hm.secp_decompress(shares[0][i].public_key),
                    int.from_bytes(digests[i].tobytes(), "big"),
                    int.from_bytes(out["r"][i].tobytes(), "big"),
                    int.from_bytes(out["s"][i].tobytes(), "big"))
    for i in range(B))
try:  # the checkout's per-shape graphs: keys captured, their capture seconds
    from mpcium_tpu_torch.engine import graphs
    keys = [e for e in graphs.entries() if e["fn"].startswith("gg18.")]
    captured = {"keys": len(keys), "capture_s": sum(e["capture_s"] for e in keys),
                "pool_bytes": sum(e["pool_bytes"] for e in keys)}
except ImportError:
    captured = None
card = "cpu"
if device == "cuda":
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
print(json.dumps({
    "root": root, "B": B, "seed": seed, "card": card, "first_sign_s": first,
    "sign_s": warm, "sigs_per_s": B / warm, "phases_s": phases,
    "launches": K.launches + sum(by_mode.values()), "plain_calls": K.plain_calls,
    "ok_all": bool(out["ok"].all()), "verified": verified, "gg18_graphs": captured,
    "memory_reserved": torch.cuda.memory_reserved() if device == "cuda" else None,
}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal")
    args = ap.parse_args()
    bad = 0
    for root in args.roots:
        root = str(Path(root).resolve())
        proc = subprocess.run(
            [sys.executable, "-c", RUN, root, str(args.batch), str(args.seed), args.device],
            capture_output=True, text=True,
        )
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(json.dumps({"root": root, "rc": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
            bad += 1
            continue
        rec = json.loads(lines[-1])
        print(lines[-1], flush=True)
        bad += not (rec["ok_all"] and rec["verified"] == args.batch)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
