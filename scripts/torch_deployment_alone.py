"""Phase 25 of ``chip_smoke.py`` (the networked deployment) alone: a
broker and three daemon processes on the GPU, driven through
``RemoteCluster`` as chip_smoke's child process drives them; every
signature verified on the host pool, and the phase's lines printed.

    python3 scripts/torch_deployment_alone.py [W]         # W wallets, default 64
    python3 scripts/torch_deployment_alone.py W --cpu     # a rehearsal without a GPU

With ``--cpu`` the daemons run ``--device cpu`` (K0's plain versions).
"""
import sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs

if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    if not cpu:
        print(cs.smi(), flush=True)
    W = int(args[0]) if args else cs.DEPLOY_W
    t0 = time.perf_counter()
    try:
        res = cs.deployment_run(W, 1, dev="cpu" if cpu else None)
        res["record"]["phase_s"] = time.perf_counter() - t0
        cs.serving_finish(res, {"alone": True}, "deployment")
    finally:
        print("script_s", time.perf_counter() - t0, flush=True)
        if cs._POOL is not None:
            cs._POOL.shutdown(cancel_futures=True)
