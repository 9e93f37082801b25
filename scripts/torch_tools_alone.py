#!/usr/bin/env python3
"""The port's tools on the GPU, each as a child process, one after the
other: the verify drive, the trace gate's regeneration, the micro-bench
gate, the prewarm CLI and the signing example.

    python3 scripts/torch_tools_alone.py [--cpu] [--only NAME,...]

Steps (``--only`` picks some by name):

- ``verify_drive``: ``scripts/torch_verify_drive.py``; all four stages
  pass, and on the GPU the sign stage launches K0 with no plain call;
- ``trace_regen``: ``scripts/torch_trace_check.py --regen --no-sweep``
  (the sample it writes passes the check, the traced and untraced
  transcripts are equal);
- ``perf_baseline``, ``perf_gate``, ``perf_slowdown``:
  ``scripts/torch_perfcheck.py --update-baseline``, then the gate against
  it (exit 0, strict: same host and device), then ``--inject-slowdown
  4`` (exit 1);
- ``prewarm``: ``scripts/torch_prewarm.py --schemes eddsa,ecdsa
  --max-b 64`` (``failed`` 0);
- ``example_sign``: ``examples/torch/sign.py`` (both curves sign and
  verify).

Each step prints one JSON line (exit code, the code it must give, wall
seconds, the child's result lines; the example's with the second each
arrived at); each child's whole output goes to
``chiprun_out/tools/<step>.log``, and the files the steps write (the
trace sample, the baseline, the warm report) are copied beside it. The
first line is the card's name and power limit. Exit 0 when every step
gave its code. ``--cpu`` passes ``--device cpu`` to every child (a
rehearsal; the prewarm and example steps take tens of minutes there).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "tools"
BASELINE = ROOT / "mpcium_tpu_torch" / "data" / "perf_baseline_micro_gpu.json"
SAMPLE = ROOT / "mpcium_tpu_torch" / "data" / "trace_sample.json"

# (step, argv after the interpreter, exit code it must give, timeout s)
STEPS = [
    ("verify_drive", ["scripts/torch_verify_drive.py"], 0, 1800),
    ("trace_regen", ["scripts/torch_trace_check.py", "--regen", "--no-sweep"], 0, 900),
    ("perf_baseline", ["scripts/torch_perfcheck.py", "--update-baseline"], 0, 900),
    ("perf_gate", ["scripts/torch_perfcheck.py"], 0, 900),
    ("perf_slowdown", ["scripts/torch_perfcheck.py", "--inject-slowdown", "4"], 1, 900),
    ("prewarm", ["scripts/torch_prewarm.py", "--schemes", "eddsa,ecdsa", "--max-b", "64",
                 "--out", str(OUT / "warm")], 0, 1800),
    ("example_sign", ["examples/torch/sign.py"], 0, 1200),
]


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def _result_lines(step: str, stamped: list) -> list:
    """The lines a step's reading needs, from its (seconds, line) stdout."""
    lines = [ln for _t, ln in stamped if ln.strip()]
    if step == "verify_drive":
        return [json.loads(ln) for ln in lines if ln.startswith("{")] + \
            [ln for ln in lines if ln.startswith("VERIFY-DRIVE")]
    if step.startswith("perf_") or step == "trace_regen":
        return [ln for ln in lines if ln.startswith(("perfcheck", "trace-check"))]
    if step == "prewarm":  # the totals (an indented object), then K0's line
        if "{" not in lines or "}" not in lines:
            return lines[-5:]
        totals = "\n".join(lines[lines.index("{"):lines.index("}") + 1])
        return [json.loads(totals)] + [json.loads(ln) for ln in lines if ln.startswith('{"k0"')]
    # the example: each line with the second it arrived at
    return [{"t_s": t, "line": ln} for t, ln in stamped[-8:] if ln.strip()]


def _k0_check(lines: list, cpu: bool):
    """On the GPU the sign stage must launch K0 and call no plain version."""
    sign = next((ln for ln in lines if isinstance(ln, dict) and ln.get("stage") == "sign"), None)
    if sign is None:
        return "no sign stage line"
    k0 = sign["k0"]
    n = k0["launches"] + sum(k0["powmod_launches_by_mode_width"].values())
    if not cpu and (n == 0 or k0["plain_calls"] != 0):
        return f"sign stage K0 launches {n}, plain_calls {k0['plain_calls']}"
    return None


def run_step(step: str, argv: list, expect: int, timeout_s: float, cpu: bool) -> dict:
    """Run one child in its own process group (killed whole at the
    timeout), its stdout stamped with seconds since its start."""
    cmd = [sys.executable, *argv] + (["--device", "cpu"] if cpu else [])
    err_path = OUT / f"{step}.stderr"
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True,
                                start_new_session=True)
        timer = threading.Timer(timeout_s, os.killpg, (proc.pid, signal.SIGKILL))
        timer.start()
        try:
            stamped = [(round(time.perf_counter() - t0, 3), ln.rstrip("\n")) for ln in proc.stdout]
            rc = proc.wait()
        finally:
            timed_out = not timer.is_alive() and proc.returncode == -signal.SIGKILL
            timer.cancel()
    wall = time.perf_counter() - t0
    err_text = err_path.read_text()
    err_path.unlink()
    (OUT / f"{step}.log").write_text(
        f"$ {' '.join(cmd)}\n--- stdout (s since start)\n"
        + "".join(f"{t:9.3f}  {ln}\n" for t, ln in stamped) + f"--- stderr\n{err_text}")
    try:
        lines = _result_lines(step, stamped)
    except ValueError as e:
        lines = [f"unparsed: {e!r}"]
    rec = {"step": step, "rc": None if timed_out else rc, "expect_rc": expect,
           "ok": not timed_out and rc == expect, "wall_s": round(wall, 3), "lines": lines}
    if timed_out:
        rec["fault"] = f"killed at its {timeout_s} s timeout"
    if step == "verify_drive" and rec["ok"]:
        fault = _k0_check(lines, cpu)
        if fault:
            rec.update(ok=False, fault=fault)
    if not rec["ok"]:
        rec["stderr_tail"] = err_text[-1500:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="pass --device cpu to every child")
    ap.add_argument("--only", default="", help="comma list of steps to run (default all)")
    args = ap.parse_args(argv)
    only = {s for s in args.only.split(",") if s}
    unknown = only - {s for s, *_ in STEPS}
    if unknown:
        ap.error(f"unknown steps {sorted(unknown)}")

    print(smi(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ok = True
    for step, cmd, expect, timeout_s in STEPS:
        if only and step not in only:
            continue
        rec = run_step(step, cmd, expect, timeout_s, args.cpu)
        ok &= rec["ok"]
        print(json.dumps(rec), flush=True)
    for f in (SAMPLE, BASELINE):
        if f.exists():
            shutil.copy(f, OUT / f.name)
    print(json.dumps({"tools_ok": ok, "script_s": round(time.perf_counter() - t0, 3)}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
