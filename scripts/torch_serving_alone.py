"""Phase 24 of ``chip_smoke.py`` (the serving path) alone on the GPU:
build K0, run the phase in-process as chip_smoke's child process does,
verify every signature on the host pool and print the phase's lines.

    python3 scripts/torch_serving_alone.py [W]   # W wallets, default 64
"""
import sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs

if __name__ == "__main__":
    print(cs.smi(), flush=True)
    W = int(sys.argv[1]) if len(sys.argv) > 1 else cs.SERVING_W
    t0 = time.perf_counter()
    try:
        res = cs._serving_task(W, 1, gg18_rows=False)  # phase 36: torch_gg18_graphs_alone.py
        cs.serving_finish(res, {"alone": True})
    finally:
        print("script_s", time.perf_counter() - t0, flush=True)
        if cs._POOL is not None:
            cs._POOL.shutdown(cancel_futures=True)
