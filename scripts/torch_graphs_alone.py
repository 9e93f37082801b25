"""The EdDSA engine's per-shape CUDA graphs on the GPU alone, and the
party and engine sign walls of two checkouts in one call.

    python3 scripts/torch_graphs_alone.py                  # phase 35 of chip_smoke.py
    python3 scripts/torch_graphs_alone.py --ab DIR [DIR..] # walls of each checkout, in turns
    python3 scripts/torch_graphs_alone.py --cpu            # a rehearsal without a GPU (B 1, 2)

Without ``--ab`` it runs ``chip_smoke.py``'s phase 35 (``run_graphs``:
every graphed function's replay against its eager body at B = 1, 16 and
1,024, the party sign through graphs against the eager one, three
threads replaying one key) and prints its line.

With ``--ab`` each DIR is a checkout of the repo (this one is ``.``;
unpack another with ``git archive`` under ``.scratch/``). Each runs as a
child process that imports that checkout's package only, one after the
other in the order given (pass them as parent, change, change, parent):
a 2-of-3 batched party sign (``BatchedEDDSASigningParty`` through
``run_protocol``, cohorts 1) at each B of PARTY_B, a first sign and two
warm ones; the engine sign (``BatchedCoSigners``, cohorts 2) at
ENGINE_B, a first and a warm one; every signature of the last sign
at each size verified on the host (256 sampled rows of the engine's);
``torch.cuda.memory_reserved()`` after
each size; and that checkout's ``scripts/torch_eddsa_opcount.py --device
cuda --batch 1 --cohorts 1``. One JSON line per child, with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARTY_B = (1, 16, 1024)
ENGINE_B = 4096  # cell 3
TIMEOUT_S = 900.0  # per child and per op count


def _child(root: str, party_bs, engine_b: int, dev: str) -> dict:
    """The walls of one checkout, in this process (``root`` first on the
    path)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils.rng import SeededStream

    assert eb.__file__.startswith(os.path.abspath(root)), eb.__file__
    torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def mem():
        return torch.cuda.memory_reserved() if dev == "cuda" else None

    def verified(shares, msgs, sigs) -> int:
        return sum(hm.ed25519_verify(s.public_key, m, bytes(sig))
                   for s, m, sig in zip(shares, msgs, sigs))

    out = {"root": root, "device": dev, "party": {}, "engine": {}}
    ids = ["node0", "node1", "node2"]
    for B in party_bs:
        shares = eb.dealer_keygen_batch(B, ids, 1, rng=SeededStream(7))
        msgs = [r.tobytes() for r in np.random.default_rng(8).integers(0, 256, (B, 32),
                                                                     dtype=np.uint8)]
        walls = []
        for k in range(3):
            parties = {pid: BatchedEDDSASigningParty(f"ab-{B}-{k}", pid, ids[:2], shares[i],
                                                     msgs, rng=SeededStream(9 + i), cohorts=1,
                                                     device=dev)
                       for i, pid in enumerate(ids[:2])}
            t0 = time.perf_counter()
            run_protocol(parties)
            sync()
            walls.append(time.perf_counter() - t0)
        res = parties["node0"].result
        out["party"][str(B)] = {"first_s": walls[0], "warm_s": walls[1:],
                                "ok": bool(res["ok"].all()),
                                "verified": verified(shares[0], msgs, res["signatures"]),
                                "memory_reserved": mem()}
    B = engine_b
    shares = eb.dealer_keygen_batch(B, ids, 1, rng=SeededStream(10))
    msgs = [r.tobytes() for r in np.random.default_rng(11).integers(0, 256, (B, 32),
                                                                  dtype=np.uint8)]
    signer = eb.BatchedCoSigners(ids[:2], shares[:2], rng=SeededStream(12), device=dev)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        sigs, ok = signer.sign(msgs, cohorts=2)
        sync()
        walls.append(time.perf_counter() - t0)
    rows = range(0, B, max(1, B // 256))  # a sample of 256 rows: the host check is slow
    out["engine"] = {"B": B, "first_s": walls[0], "warm_s": walls[1], "ok": bool(ok.all()),
                     "verified": verified([shares[0][i] for i in rows], [msgs[i] for i in rows],
                                          sigs[list(rows)]),
                     "verified_of": len(rows), "memory_reserved": mem()}
    try:
        from mpcium_tpu_torch.engine import graphs

        out["graphs"] = {"entries": len(graphs.entries()),
                         "captures": sum(c["captures"] for c in graphs.counts().values())}
    except ImportError:
        out["graphs"] = None
    return out


def _opcount(root: str, dev: str, timeout: float) -> dict:
    root = os.path.abspath(root)
    r = subprocess.run([sys.executable, os.path.join(root, "scripts", "torch_eddsa_opcount.py"),
                        "--device", dev, "--batch", "1", "--cohorts", "1"],
                       capture_output=True, text=True, timeout=timeout, cwd=root)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if r.returncode == 0 and lines else {
        "rc": r.returncode, "stderr": r.stderr[-2000:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", nargs="+", metavar="DIR")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"
    if args.child:
        print(json.dumps(_child(args.child, PARTY_B, ENGINE_B, dev)), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = cs.smi() if dev == "cuda" else None
    if card:
        print(card, flush=True)
    os.environ[cs.T0_ENV] = repr(time.monotonic())
    if not args.ab:
        if args.cpu:  # the CPU rehearsal: small batches, one torch thread
            import torch

            torch.set_num_threads(1)
        rec = cs.run_graphs(1, dev, *(((1, 2), 2) if args.cpu else ()))
        cs.emit(rec)
        cs.check_graphs(rec)
        return 0
    failed = False
    for i, root in enumerate(args.ab):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, __file__, "--child", root]
                           + (["--cpu"] if args.cpu else []),
                           capture_output=True, text=True, timeout=TIMEOUT_S)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        rec = json.loads(lines[-1]) if r.returncode == 0 and lines else {
            "root": root, "rc": r.returncode, "stderr": r.stderr[-3000:]}
        rec.update(turn=i, child_s=time.perf_counter() - t0, nvidia_smi=card,
                   opcount=_opcount(root, dev, TIMEOUT_S))
        failed |= "rc" in rec or not all(p["ok"] and p["verified"] == int(b)
                                         for b, p in rec["party"].items())
        cs.emit({"phase": "graphs_ab", **rec})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
