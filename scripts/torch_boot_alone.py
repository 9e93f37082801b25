"""The daemon's boot on the GPU alone: ``chip_smoke.py``'s phase 29 (the
warm pass over every serving engine at bucket 1), phase 28 (the session
axis split over a mesh of the card: the EdDSA step, the GG18 curve leg,
K0), then phase 25 (a broker and three daemons that warm their EdDSA
buckets at boot) at W wallets; every signature verified on the host
pool, and the phases' lines printed.

    python3 scripts/torch_boot_alone.py [W]             # W wallets in phase 25, default 64
    python3 scripts/torch_boot_alone.py 0               # phases 29 and 28 only
    python3 scripts/torch_boot_alone.py W --cpu         # a rehearsal without a GPU

With ``--cpu`` every phase runs on the CPU at small sizes (K0's plain
versions; the EdDSA, GG18 and K0 legs at B=8).
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    W = int(args[0]) if args else cs.DEPLOY_W
    dev = "cpu" if cpu else "cuda"
    if cpu:
        cs.SHARDED_EDDSA_B = cs.SHARDED_GG18_B = cs.SHARDED_MULMOD_B = 8
    else:
        print(cs.smi(), flush=True)
    import torch

    from mpcium_tpu_torch.ops import mulmod as K

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        warm = cs.warm_run(K, dev)
        sharded = cs.sharded_run(1, K, dev)
        cs.boot_finish({"warm": warm, "sharded": sharded}, {"alone": True})
        if W:
            res = cs.deployment_run(W, 1, dev="cpu" if cpu else None)
            res["record"]["phase_s"] = time.perf_counter() - t0
            cs.serving_finish(res, {"alone": True}, "deployment")
    finally:
        print("script_s", time.perf_counter() - t0, flush=True)
        if cs._POOL is not None:
            cs._POOL.shutdown(cancel_futures=True)
