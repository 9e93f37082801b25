"""The measurement tooling on the GPU alone: ``chip_smoke.py``'s phase 4
(the B-wallet Paillier slice: keygen, a first and a measured warm sign),
phase 30 (a third sign under tracing and ``torch.profiler``, folded into
its phases), phase 8 (the OT slice), phase 31 (a traced OT sign) and
phase 32 (the micro-benches and their gate); the phases' lines printed.

    python3 scripts/torch_profile_alone.py [B]          # B sessions, default 1024
    python3 scripts/torch_profile_alone.py B --cpu      # a rehearsal without a GPU

With ``--cpu`` the signs run on the CPU on the 1024-bit key fixture with
its shrunk exponent domains (K0's plain versions), the capture holds no
device event and the micro-benches take 10 samples (at 3 the gate's rank
test cannot reach its alpha, so no row could be flagged).
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _cpu_slices(B: int, K):
    """The slices' signers on the CPU: the Paillier signer on the 1024-bit
    fixture (with a measured warm sign) and the OT signer."""
    import numpy as np

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils import span_golden as sg
    from mpcium_tpu_torch.utils.rng import SeededStream

    shares = gb.dealer_keygen_secp_batch(B, cs.UNIVERSE, 1, rng=SeededStream(1))
    signer = gb.GG18BatchCoSigners(
        ["node0", "node1"], shares[:2], load_test_preparams(1024),
        dom=gb.Domains(**sg.PAILLIER_DOMAINS), rng=SeededStream(2), device="cpu")
    digests = np.random.default_rng(3).integers(0, 256, (B, 32), dtype=np.uint8)
    phases: dict = {}
    t0 = time.perf_counter()
    signer.sign(digests, phase_times=phases, cohorts=cs.COHORTS)
    measured = {"sign_s": time.perf_counter() - t0, "phases_s": phases}
    ot = gb.GG18BatchCoSigners(["node0", "node1"], shares[:2], rng=SeededStream(4),
                               mta_impl="ot", device="cpu")
    return shares, signer, measured, ot


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    B = int(args[0]) if args else 1024
    import torch

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.ops import mulmod as K

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        if cpu:
            torch.set_num_threads(1)  # tiny float64 matmuls: threads only contend
            shares, signer, measured, ot = _cpu_slices(B, K)
            cs.run_profile(signer, shares, B, 1, K, measured, dev="cpu")
            cs.run_ot_profile(ot, shares, B, 1, dev="cpu")
            cs.run_microbench(samples=10, dev="cpu")
        else:
            print(cs.smi(), flush=True)
            K.build()
            _w, _m, shares, signer, measured = cs.run_slice(B, 1, load_test_preparams(2048), K)
            cs.run_profile(signer, shares, B, 1, K, measured)
            ot = cs.run_ot_slice(B, 1, shares, K)
            cs.run_ot_profile(ot, shares, B, 1)
            cs.run_microbench()
    finally:
        print("script_s", time.perf_counter() - t0, flush=True)
        if cs._POOL is not None:
            cs._POOL.shutdown(cancel_futures=True)
