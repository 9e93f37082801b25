"""The GG18 engine's per-shape CUDA graphs on the GPU alone.

    python3 scripts/torch_gg18_graphs_alone.py [--out FILE]   # phase 36 of chip_smoke.py
    python3 scripts/torch_gg18_graphs_alone.py --cpu          # a rehearsal without a GPU

It builds K0 and runs ``chip_smoke.py``'s phase 36: the flagship engine
sign at B=1,024 (2048-bit fixture, cohorts 2; in chip_smoke.py phase
4's signer) as a warm-up, then through graphs only and with every body
eager under the same seeded stream (``gg18_engine_runs``); each of the
25 graphed functions' replay against its eager body at B = 1, 16 and
1,024, the batched party at B=16 (1024-bit fixture) through graphs and
eager, three threads replaying one key (``gg18_party_threads``,
``gg18_graph_rows``). It prints
the phase line (and writes it to ``--out``, the whole line being longer
than a chip call's output tail) and exits 1 if a check failed. The CPU
rehearsal runs B = 1 and 2 and the signs at B=2 on the 1024-bit fixture
with the domains it can carry (several minutes: the Paillier MtA runs
K0's plain version).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", help="also write the phase line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from mpcium_tpu_torch.ops import mulmod as K

    os.environ[cs.T0_ENV] = repr(time.monotonic())
    if args.cpu:  # small batches, one torch thread
        from mpcium_tpu_torch.engine import gg18_batch as gb
        from mpcium_tpu_torch.warm.prewarm import _FIXTURE_DOMAINS

        torch.set_num_threads(1)
        dev, bs, party_b = "cpu", (1, 2), 2
        signer, shares, first_s = cs.gg18_engine_signer(
            2, args.seed, dev, bits=1024, dom=gb.Domains(**_FIXTURE_DOMAINS))
    else:
        print(cs.smi(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        K.build()
        dev, bs, party_b = "cuda", cs.GG18_GRAPHS_B, cs.GG18_GRAPHS_PARTY_B
        signer, shares, first_s = cs.gg18_engine_signer(cs.GG18_GRAPHS_ENGINE_B, args.seed)
    engine = cs.gg18_engine_runs(signer, shares, args.seed, K, dev)
    party_threads = cs.gg18_party_threads(args.seed, K, dev, party_b)
    rows = cs.gg18_graph_rows(args.seed, dev, bs)
    rec = cs.gg18_graphs_finish([rows], party_threads, {**engine, "first_s": first_s}, dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec) + "\n")
    cs.emit(rec)
    cs.check_gg18_graphs(rec)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        import chip_smoke as cs

        if cs._POOL is not None:
            cs._POOL.shutdown()
    sys.exit(rc)
