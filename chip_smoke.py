#!/usr/bin/env python3
"""Drive the PyTorch port (mpcium_tpu_torch) once on a CUDA GPU.

Phases, each printing one JSON line:

1. env — the card (nvidia-smi name and power limit), torch/CUDA
   versions, and the time to build the mulmod kernel from csrc/.
2. kernel_vs_plain — for each modulus width of the signing path
   (2048-bit N, NTilde, p² and 4096-bit N² of the 2048-bit fixture):
   B random reduced operands plus the edges 0, 1, m-1 and the unreduced
   operands R^occ - 1 and 2^(32k) that the JAX kernel still accepts; the
   kernel must equal the plain PyTorch version bit for bit, and sampled
   rows (the edges among them) must equal python-int a·b mod m. Rows of
   all-ones limbs, beyond the JAX kernel's domain, must still equal
   python ints. Times come from CUDA events: one event pair around 100
   back-to-back calls, divided by 100, median of twenty such groups, with
   the host's own time per enqueued call beside each. The kernel's own
   time comes from a CUDA graph of 100 launches of its C entry point,
   replayed between one event pair, so no host work sits between the
   launches; the wrapper's time per call (host work included) and the
   plain version's are printed beside it.
3. powmod_vs_plain — the whole-exponentiation entry in each mode
   (row: per-row exponent; shared: one exponent for the batch; comb:
   fixed-base comb table) at n=320 (2048-bit N) and n=608 (4096-bit
   N²), B rows, at the exponent widths of the signing path (256, 760
   and 1784 bits per row, the 1024-bit decryption exponent p-1 shared,
   RAND_BITS and 1784 bits for the comb). Edge rows: bases 0, 1, m-1
   and exponents 0, 1, all ones. The kernel must equal the plain
   version bit for bit, and sampled rows (the edges among them) python
   ``pow``; unreduced bases R^occ-1 and all-ones rows, beyond the plain
   version's domain, must equal python ``pow``. Kernel ms per launch:
   one CUDA event pair around each of seven launches of the C entry,
   median; the plain version's ms from one event pair around its call;
   the steps (modular multiplies) each row needs, from the digits.
4. slice — dealer keygen for B wallets (2-of-3), then two GG18
   Paillier-MtA batched signatures over B digests each with a seeded
   stream: the first builds the per-key fixed-base tables and is
   reported as first_sign_s; the second is the measured one (sigs/s).
   Every (r, s) of the measured sign is verified on the host with the
   port's python-int ECDSA verifier; the kernel launch counters are
   zeroed just before it and must show launches of both entries at both
   widths (powmod: row and comb at both, shared at n=320), and the
   plain versions none.
5. golden — the B=2 case of the JAX engine's committed golden signed on
   the card: (r, s, recovery, ok) must match byte for byte.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero.

    python3 chip_smoke.py [--batch 1024] [--seed 1]
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "gg18_paillier_b2_1024.json"
COHORTS = 2
REPS, GROUPS = 100, 20  # calls per CUDA event pair; pairs per median
POWMOD_TIMINGS = 7  # event pairs (one launch each) per powmod median
# (mode, n) of every powmod the signing path launches, and the exponent
# width (one the path gives it) whose measurement stands for it in the
# kernels line. A warm sign's exponents: row 256 bits at n=320; row 128,
# 256, 760 and 1032 at n=608; shared 1024 (p-1, q-1) at n=320; comb 256
# to 2824 at n=320 and 256 (RAND_BITS) at n=608.
POWMOD_PATH = {("row", 320): 256, ("row", 608): 760, ("shared", 320): 1024,
               ("comb", 320): 1784, ("comb", 608): 256}

# H100 SXM peaks for the bound: HBM3 at 3.35 TB/s (NVIDIA data sheet), and
# 32-bit integer multiply-add at 64 per clock per SM (CUDA C++ Programming
# Guide throughput table, compute capability 9.0) × 132 SMs × 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def mulmod_bound_ms(rows: int, n: int, modulus: int):
    """Least time for `rows` products a·b mod m: the bytes moved (a, b in,
    result out, int32 limbs) over HBM bandwidth, and the 32-bit word
    products of a Barrett multiply (k² for a·b, ~k²/2 for the quotient
    estimate, ~k²/2 for the low half of q·m; two int32 multiply-adds per
    32x32→64 product) over the int32 rate."""
    k = -(-modulus.bit_length() // 32)
    t_bytes = 3 * rows * n * 4 / HBM_BYTES_PER_S
    t_ops = rows * 2 * k * k * 2 / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def powmod_bound_ms(steps: int, moved_bytes: int, modulus: int):
    """Least time for one powmod launch: the bytes it must move (rows and
    digits in, results out, each comb table entry the digits select read
    once) over HBM bandwidth, and the Barrett word products of all its
    steps (2k² per step, as in mulmod_bound_ms) over the int32 rate."""
    k = -(-modulus.bit_length() // 32)
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = steps * 2 * k * k * 2 / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn):
    """(device ms per call, host ms per call): one CUDA event pair around
    REPS back-to-back calls, divided by REPS; median of GROUPS groups.
    The host time is what enqueueing one call costs; while it stays
    below the device time the queue never drains and the event time is
    the device's.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(GROUPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / REPS)
        e.record()
        e.synchronize()
        dev.append(s.elapsed_time(e) / REPS)
    return statistics.median(dev), statistics.median(host)


def kernel_graph_ms(K, a, b, c) -> float:
    """Device ms per launch of the kernel's C entry point on fixed
    (rows, n) operands: REPS launches captured into one CUDA graph,
    replayed between one event pair; median of GROUPS replays. The
    wrapper's checks, broadcasting and counting are left out."""
    import torch

    fn = K.build().mpcium_mulmod
    out = torch.empty_like(a)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        args = (
            a.data_ptr(), b.data_ptr(), out.data_ptr(), c.m_words.data_ptr(),
            c.mu_words.data_ptr(), a.shape[0], c.n, c.k, side.cuda_stream,
        )
        for _ in range(REPS):
            if fn(*args) != 0:
                raise RuntimeError("mulmod kernel launch failed during capture")
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GROUPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / REPS)
    if not torch.equal(out, K.mulmod_plain(a, b, c)):
        raise AssertionError("graph-replayed kernel != plain version")
    return statistics.median(times)


def kernel_vs_plain(B: int, seed: int, pre, K, mm, bn):
    import torch

    p0 = pre["node0"]
    moduli = [
        ("N", p0.paillier.N), ("NTilde", p0.NTilde),
        ("p2", p0.paillier.p ** 2), ("N2", p0.paillier.N ** 2),
    ]
    rnd = random.Random(seed)
    results = {}
    for label, m in moduli:
        ctx = mm.MXUBarrett(m, device="cuda")
        n, occ, k = ctx.prof.n_limbs, ctx.occ, ctx._kc.k
        # unreduced operands the JAX kernel accepts (a·b < R^occ·m)
        top = 1 << (7 * occ)
        edges = [top - 1] + [1 << (32 * k)] * ((1 << (32 * k)) < top)
        av = [0, 1, m - 1]
        bv = [rnd.randrange(m), m - 1, m - 1]
        for e in edges:
            av += [e, m - 1]
            bv += [m - 1, e]
        ne = len(av)
        av += [rnd.randrange(m) for _ in range(B - ne)]
        bv += [rnd.randrange(m) for _ in range(B - ne)]
        a = torch.as_tensor(bn.batch_to_limbs(av, ctx.prof), device="cuda")
        b = torch.as_tensor(bn.batch_to_limbs(bv, ctx.prof), device="cuda")
        got = K.mulmod_cuda(a, b, ctx._kc)
        ref = K.mulmod_plain(a, b, ctx._kc)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).any(-1).sum())
            raise AssertionError(f"{label}: kernel != plain in {bad} rows")
        sample = list(range(ne)) + rnd.sample(range(ne, B), 13)
        host = bn.batch_from_limbs(got[sample], ctx.prof)
        for i, v in zip(sample, host):
            if v != av[i] * bv[i] % m:
                raise AssertionError(f"{label}: row {i} != python a*b % m")
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        # all-ones rows lie beyond the JAX kernel's domain: python ints only
        full = (1 << (7 * n)) - 1
        wide = torch.as_tensor(bn.batch_to_limbs([full, full, 1], ctx.prof), device="cuda")
        if bn.batch_from_limbs(K.mulmod_cuda(wide, wide.flip(0), ctx._kc), ctx.prof) != [
            full % m, full * full % m, full % m,
        ]:
            raise AssertionError(f"{label}: all-ones rows != python a*b % m")
        k_ms = kernel_graph_ms(K, a, b, ctx._kc)
        w_ms, w_host = time_ms(lambda: K.mulmod_cuda(a, b, ctx._kc))
        p_ms, _ = time_ms(lambda: K.mulmod_plain(a, b, ctx._kc))
        bound, by = mulmod_bound_ms(B, n, m)
        rec = {
            "phase": "kernel_vs_plain", "modulus": label, "bits": m.bit_length(),
            "n_limbs": n, "rows": B, "edge_rows": ne, "equal": True,
            "max_abs_err": err, "kernel_ms": k_ms, "wrapper_ms": w_ms,
            "wrapper_host_ms_per_call": w_host,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
        }
        emit(rec)
        # one row per kernel width: the widest-modulus measurement stands
        if n not in results or m.bit_length() >= results[n]["bits"]:
            results[n] = rec
    return results


def powmod_launch_ms(K, L, c) -> float:
    """Device ms per launch of the powmod kernel's C entry on packed
    operands (``launch_powmod``: no checks, no counting): one CUDA event
    pair around each launch, median of POWMOD_TIMINGS after one warm-up
    launch."""
    import torch

    out = torch.empty((L.rows, c.n), dtype=torch.int32, device="cuda")
    times = []
    for i in range(POWMOD_TIMINGS + 1):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        if K.launch_powmod(L, c, out) != 0:
            raise RuntimeError("powmod kernel launch failed")
        e.record()
        e.synchronize()
        if i:
            times.append(s.elapsed_time(e))
    return statistics.median(times)


def powmod_vs_plain(B: int, seed: int, pre, K, mm, bn):
    import numpy as np
    import torch

    from mpcium_tpu_torch.ops.paillier_mxu import RAND_BITS

    p0 = pre["node0"]
    N, p = p0.paillier.N, p0.paillier.p
    rnd = random.Random(seed + 7)
    nrng = np.random.default_rng(seed + 7)
    results = {}
    for label, m in (("N", N), ("N2", N * N)):
        ctx = mm.MXUBarrett(m, device="cuda")
        c, n = ctx._kc, ctx.prof.n_limbs
        cases = [("row", 256), ("row", 760), ("row", 1784),
                 ("shared", (p - 1).bit_length()), ("comb", RAND_BITS), ("comb", 1784)]
        for mode, ebits in cases:
            xs = [0, 1, m - 1] + [rnd.randrange(m) for _ in range(B - 3)]
            eb = nrng.integers(0, 2, (B, ebits)).astype(np.int32)
            eb[3], eb[4], eb[5] = 0, 0, 1
            eb[4, 0] = 1  # rows 3, 4, 5: e = 0, 1, all ones
            es = [int("".join(map(str, r[::-1])), 2) for r in eb]
            x = torch.as_tensor(bn.batch_to_limbs(xs, ctx.prof), device="cuda")
            ebt = torch.as_tensor(eb, device="cuda")
            table = None
            if mode == "row":
                args = (x, mm._window_digits(ebt, 4))
                want = lambda i: pow(xs[i], es[i], m)  # noqa: E731
            elif mode == "shared":
                e = p - 1
                nw = -(-e.bit_length() // 4)
                ds = torch.tensor([(e >> (4 * i)) & 15 for i in range(nw)],
                                  dtype=torch.int32, device="cuda")
                args = (x, ds)
                want = lambda i: pow(xs[i], p - 1, m)  # noqa: E731
            else:
                base = rnd.randrange(2, m)
                ctx.powmod_fixed_base(base, ebt[:1])  # builds the comb table
                table = ctx._fb_tables[(base, -(-ebits // mm.COMB_W), mm.COMB_W)]
                args = (None, mm._window_digits(ebt, mm.COMB_W))
                want = lambda i: pow(base, es[i], m)  # noqa: E731
            got = K.powmod_cuda(*args, c, mode, table)
            s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_.record()
            ref = K.powmod_plain(*args, c, mode, table)
            e_.record()
            e_.synchronize()
            plain_ms = s_.elapsed_time(e_)
            if not torch.equal(got, ref):
                bad = int((got != ref).any(-1).sum())
                raise AssertionError(f"powmod {mode} {label}: kernel != plain in {bad} rows")
            sample = list(range(6)) + rnd.sample(range(6, B), 13)
            host = bn.batch_from_limbs(got[sample], ctx.prof)
            for i, v in zip(sample, host):
                if v != want(i):
                    raise AssertionError(f"powmod {mode} {label}: row {i} != python pow")
            err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
            extra = []
            if mode == "shared":
                # exponent edges of a shared exponent: one launch each
                for e in (0, 1, (1 << ebits) - 1):
                    nw = max(1, -(-e.bit_length() // 4))
                    ds = torch.tensor([(e >> (4 * i)) & 15 for i in range(nw)],
                                      dtype=torch.int32, device="cuda")
                    g = K.powmod_cuda(x[:8], ds, c, mode)
                    if not torch.equal(g, K.powmod_plain(x[:8], ds, c, mode)) or (
                        bn.batch_from_limbs(g, ctx.prof) != [pow(v, e, m) for v in xs[:8]]
                    ):
                        raise AssertionError(f"powmod shared {label}: exponent {e:#x}")
                    extra.append(e.bit_length())
            if mode != "comb":
                # unreduced bases: python ints only
                wide = [(1 << (7 * ctx.occ)) - 1, (1 << (7 * n)) - 1] * 2
                xw = torch.as_tensor(bn.batch_to_limbs(wide, ctx.prof), device="cuda")
                if mode == "row":
                    ew = [1, es[6], (1 << ebits) - 1, es[7]]
                    g = K.powmod_cuda(xw, args[1][[4, 6, 5, 7]], c, mode)
                else:
                    ew = [p - 1] * 4
                    g = K.powmod_cuda(xw, args[1], c, mode)
                if bn.batch_from_limbs(g, ctx.prof) != [pow(v, e, m) for v, e in zip(wide, ew)]:
                    raise AssertionError(f"powmod {mode} {label}: unreduced base != python pow")
            L = K.pack_powmod(*args, c, mode, table)
            steps = K.powmod_steps(L)
            moved = 4 * (L.digits.numel() + 2 * L.rows * n) if mode != "comb" else 4 * (
                L.digits.numel() + L.rows * n)
            if mode == "comb":
                d = L.digits.cpu().numpy()
                moved += 4 * c.k * sum(len(np.unique(col[col != 0])) for col in d.T)
            k_ms = powmod_launch_ms(K, L, c)
            host = []
            for _ in range(POWMOD_TIMINGS):
                t0 = time.perf_counter()
                K.powmod_cuda(*args, c, mode, table)
                host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            bound, by = powmod_bound_ms(int(steps.sum()), moved, m)
            rec = {
                "phase": "powmod_vs_plain", "mode": mode, "modulus": label,
                "bits": m.bit_length(), "n_limbs": n, "rows": B, "exp_bits": ebits,
                "shared_exp_edges_bits": extra, "equal": True, "max_abs_err": err,
                "kernel_ms": k_ms, "steps_max": int(steps.max()),
                "steps_total": int(steps.sum()),
                "kernel_ms_per_step": k_ms / max(int(steps.max()), 1),
                "wrapper_host_ms_per_call": statistics.median(host),
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            }
            emit(rec)
            results[(mode, n, ebits)] = rec
    return results


def run_slice(B: int, seed: int, pre, K):
    import numpy as np
    import torch

    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    t0 = time.perf_counter()
    shares = gb.dealer_keygen_secp_batch(
        B, ["node0", "node1", "node2"], threshold=1, rng=SeededStream(seed)
    )
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    signer = gb.GG18BatchCoSigners(
        ["node0", "node1"], [shares[0], shares[1]], pre, dom=gb.Domains(),
        rng=SeededStream(seed + 1), device="cuda",
    )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    drng = np.random.default_rng(seed + 2)
    first = drng.integers(0, 256, (B, 32), dtype=np.uint8)
    t0 = time.perf_counter()
    out = signer.sign(first, cohorts=COHORTS)
    torch.cuda.synchronize()
    first_sign_s = time.perf_counter() - t0
    if not out["ok"].all():
        raise AssertionError(f"first sign: ok={int(out['ok'].sum())}/{B}")
    digests = drng.integers(0, 256, (B, 32), dtype=np.uint8)
    phases: dict = {}
    K.reset_counters()
    t0 = time.perf_counter()
    out = signer.sign(digests, phase_times=phases, cohorts=COHORTS)
    torch.cuda.synchronize()
    sign_s = time.perf_counter() - t0
    launches = K.launches
    by_width = dict(K.launches_by_width)
    by_mode = dict(K.powmod_launches_by_mode_width)
    plain_calls = K.plain_calls
    t0 = time.perf_counter()
    verified = 0
    for i in range(B):
        pub = hm.secp_decompress(shares[0][i].public_key)
        r = int.from_bytes(out["r"][i].tobytes(), "big")
        s = int.from_bytes(out["s"][i].tobytes(), "big")
        d = int.from_bytes(digests[i].tobytes(), "big")
        verified += hm.ecdsa_verify(pub, d, r, s)
    verify_s = time.perf_counter() - t0
    emit({
        "phase": "slice", "B": B, "cohorts": COHORTS, "seed": seed,
        "keygen_s": keygen_s, "setup_s": setup_s, "first_sign_s": first_sign_s,
        "sign_s": sign_s,
        "sigs_per_s": B / sign_s, "phases_s": phases, "host_verify_s": verify_s,
        "ok_all": bool(out["ok"].all()), "verified": verified,
        "kernel_launches": launches + sum(by_mode.values()),
        "mulmod_launches_by_width": {str(k): v for k, v in sorted(by_width.items())},
        "powmod_launches_by_mode_width": {
            f"{m}/{n}": v for (m, n), v in sorted(by_mode.items())},
        "plain_calls": plain_calls,
    })
    if not out["ok"].all() or verified != B:
        raise AssertionError(f"signatures: ok={int(out['ok'].sum())}/{B} "
                             f"verified={verified}/{B}")
    if plain_calls:
        raise AssertionError(f"a plain version ran {plain_calls}x on the card")
    for n in (320, 608):
        if by_width.get(n, 0) == 0:
            raise AssertionError(f"no mulmod launch at width {n} during the sign")
    for key in POWMOD_PATH:
        if by_mode.get(key, 0) == 0:
            raise AssertionError(f"no powmod launch of {key} during the sign")
    return by_width, by_mode


def check_golden(device: str = "cuda") -> None:
    """The port on the card against the JAX engine's committed signatures:
    same keys, digests and seeded stream (B=2, 1024-bit fixture), so every
    byte of (r, s, recovery, ok) must match."""
    import numpy as np
    import torch

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    g = json.loads(GOLDEN.read_text())
    case = g["cases"][0]
    shares = gb.dealer_keygen_secp_batch(
        case["B"], g["universe"], g["threshold"], rng=SeededStream(case["keygen_seed"])
    )
    signer = gb.GG18BatchCoSigners(
        g["quorum"], [shares[g["universe"].index(p)] for p in g["quorum"]],
        load_test_preparams(1024), dom=gb.Domains(**g["domains"]),
        rng=SeededStream(case["sign_seed"]), device=device,
    )
    digests = np.array([list(bytes.fromhex(d)) for d in case["digests"]], np.uint8)
    t0 = time.perf_counter()
    out = signer.sign(digests, cohorts=case["cohorts"])
    if device == "cuda":
        torch.cuda.synchronize()
    got = {
        "r": [bytes(x).hex() for x in out["r"]],
        "s": [bytes(x).hex() for x in out["s"]],
        "recovery": [int(v) for v in out["recovery"]],
        "ok": [bool(v) for v in out["ok"]],
    }
    same = all(got[k] == case[k] for k in got)
    emit({"phase": "golden", "B": case["B"], "cohorts": case["cohorts"],
          "matches_jax_golden": same, "sign_s": time.perf_counter() - t0})
    if not same:
        raise AssertionError("signatures differ from the JAX engine's golden")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024, help="sessions B")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    if not (ROOT / "mpcium_tpu_torch" / "ops" / "csrc" / "mulmod.cu").is_file():
        print("chip_smoke: mpcium_tpu_torch is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.core import bignum as bn
    from mpcium_tpu_torch.ops import modmul as mm
    from mpcium_tpu_torch.ops import mulmod as K

    card = smi()
    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.split(":", 1)[-1].strip() for ln in K.build_log.splitlines()
             if "registers" in ln]
    emit({
        "phase": "env", "nvidia_smi": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
        "kernel_build_s": build_s, "ptxas": ptxas,
    })

    pre = load_test_preparams(2048)
    widths = kernel_vs_plain(1024, args.seed, pre, K, mm, bn)
    pm = powmod_vs_plain(1024, args.seed, pre, K, mm, bn)
    by_width, by_mode = run_slice(args.batch, args.seed, pre, K)
    emit({
        "phase": "wrapper_host", "note": "launches in the warm sign x host ms "
        "per wrapper call at B=1024 (kernel_vs_plain, powmod_vs_plain)",
        "mulmod_s": sum(by_width.get(n, 0) * r["wrapper_host_ms_per_call"]
                        for n, r in widths.items()) / 1e3,
        "powmod_s": sum(by_mode[key] * pm[key + (eb,)]["wrapper_host_ms_per_call"]
                        for key, eb in POWMOD_PATH.items()) / 1e3,
    })
    check_golden()

    kernels = []
    for n, rec in sorted(widths.items()):
        kernels.append({
            "name": f"mulmod_n{n}",
            "route": "cuda",
            "source": "mpcium_tpu_torch/ops/csrc/mulmod.cu",
            "replaces": "mpcium_tpu/ops/pallas_mulmod.py:91",
            "launches": by_width.get(n, 0),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,
        })
    for (mode, n), eb in POWMOD_PATH.items():
        rec = pm[(mode, n, eb)]
        kernels.append({
            "name": f"powmod_{mode}_n{n}",
            "route": "cuda",
            "source": "mpcium_tpu_torch/ops/csrc/mulmod.cu",
            "replaces": "mpcium_tpu/ops/pallas_mulmod.py:91",
            "launches": by_mode[(mode, n)],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
