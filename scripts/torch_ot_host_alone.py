"""The OT host route on the GPU alone: ``chip_smoke.py``'s phase 33 (one
OT-MtA leg at B serially, then on the device route and the host route, the
native hashing stages against the card's, 11 payload sets at B=8, and a
GG18 OT sign of B wallets under ``MPCIUM_OT_DEVICE=0``), its line
printed.

    python3 scripts/torch_ot_host_alone.py [B]          # B sessions, default 1024
    python3 scripts/torch_ot_host_alone.py B --cpu      # a rehearsal without a GPU
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    B = int(args[0]) if args else 1024
    import torch

    from mpcium_tpu_torch.ops import mulmod as K

    t0 = time.perf_counter()
    try:
        if cpu:
            torch.set_num_threads(1)  # tiny float64 matmuls: threads only contend
            cs.run_ot_host(B, 1, K, dev="cpu")
        else:
            print(cs.smi(), flush=True)
            cs.run_ot_host(B, 1, K)
    finally:
        print("script_s", time.perf_counter() - t0, flush=True)
        if cs._POOL is not None:
            cs._POOL.shutdown(cancel_futures=True)
