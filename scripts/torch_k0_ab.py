#!/usr/bin/env python3
"""Time kernel K0 (``ops/csrc/mulmod.cu``) from several checkouts, in
turns, on one GPU, at the shapes the signing path gives it.

    python3 scripts/torch_k0_ab.py [--batch 1024] [--seed 1] [--sass] DIR [DIR ...]

Each DIR is the root of a checkout that holds ``mpcium_tpu_torch/`` and
``chip_smoke.py`` (for example the parent commit unpacked with ``git
archive`` into a git-ignored directory, and ``.``). Each run is a fresh
subprocess that imports that checkout's package and ``chip_smoke.py``,
builds its kernel and runs that checkout's own phases 2-3
(``kernel_vs_plain``, ``powmod_vs_plain``: every entry held against the
plain version bit for bit and against python ints, then timed with CUDA
events). The operands come from ``--seed``, so every checkout gets the
same ones. A run's JSON lines follow one line naming its checkout and
the card's name and power limit. Order the DIRs ``parent . . parent`` to
compare two versions inside one call on one card. With ``--sass`` a
line after each run reports, from ``cuobjdump -sass`` of the library it
built, the three shortest loops of each kernel that hold four or more
64-bit multiply-adds (``IMAD.WIDE.U32``): their instructions per
multiply-add and most frequent opcodes. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

RUN = r"""
import sys
root, B, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
sys.path.insert(0, root)
import chip_smoke as cs
from mpcium_tpu_torch.cluster import load_test_preparams
from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.ops import modmul as mm
from mpcium_tpu_torch.ops import mulmod as K

K.build()
cs.emit({"root": root, "card": cs.smi(), "B": B, "seed": seed})
pre = load_test_preparams(2048)
cs.kernel_vs_plain(B, seed, pre, K, mm, bn)
cs.powmod_vs_plain(B, seed, pre, K, mm, bn)
"""


def sass_loops(so: Path) -> list:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        hit = re.search(r"Function : (\S+)", ln)
        if hit:
            name = hit[1]
            funcs[name] = []
            continue
        hit = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if hit and name:
            funcs[name].append((int(hit[1], 16), hit[2].strip()))
    out = []
    for name, body in funcs.items():
        loops = []
        for addr, ins in body:
            hit = re.search(r"BRA (?:P\d, )?0x([0-9a-f]+)", ins)
            if not hit or int(hit[1], 16) >= addr:
                continue
            seg = [re.sub(r"^@!?P\d\s+", "", i).split()[0]
                   for a, i in body if int(hit[1], 16) <= a <= addr]
            ops = collections.Counter(seg)
            wide = ops.get("IMAD.WIDE.U32", 0)
            if wide >= 4:
                loops.append({"function": name, "instructions": len(seg), "imad_wide": wide,
                              "per_imad_wide": len(seg) / wide, "top": ops.most_common(8)})
        # the innermost loops: the three shortest of each kernel
        out += sorted(loops, key=lambda r: r["instructions"])[:3]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sass", action="store_true", help="report the kernels' hot loops")
    args = ap.parse_args()
    bad = 0
    for root in args.roots:
        root = Path(root).resolve()
        rc = subprocess.run([sys.executable, "-c", RUN, str(root), str(args.batch),
                             str(args.seed)]).returncode
        if rc != 0:
            print(json.dumps({"root": str(root), "rc": rc}), flush=True)
            bad += 1
        elif args.sass:
            libs = (root / "build" / "mpcium_tpu_torch").glob("libmulmod_*.so")
            so = max(libs, key=lambda q: q.stat().st_mtime)
            print(json.dumps({"root": str(root), "sass": sass_loops(so)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
