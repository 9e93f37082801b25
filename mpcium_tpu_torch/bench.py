"""Throughput benchmark of the port: batched threshold signatures a second.

The port of the repo-root ``bench.py``: ``python -m mpcium_tpu_torch.bench
[--device cpu]``. It prints the flagship JSON line {"metric", "value",
"unit", "vs_baseline", ...} the moment the flagship number is known; each
later stage (secondary metrics, the OT variant, the batch sweep) prints
the record again, merged, so the last parseable line of stdout always
carries the flagship metric.

Flagship metric (BASELINE.md): batched 2-of-3 **secp256k1 GG18** signing at
full key size (2048-bit Paillier fixture, the default ``Domains``) through
the whole protocol, MtA with range proofs, on ``engine/gg18_batch.py``
over K0 (``ops/mulmod``). Keys and record names are ``bench.py``'s;
``platform`` is ``"gpu"`` on the card and ``"cpu"`` under ``--device cpu``,
and everything ``bench.py`` runs only on ``"tpu"`` (the profiled run, the
secondary metrics by default, the OT variant, the default sweep) runs
here only on ``"gpu"``. The record adds ``k0``: K0's launches by width
and powmod mode, and its plain calls, over the flagship's signs.

Unlike ``bench.py`` there is no backend probe, no re-exec pinned to the
CPU and no degraded path: without a GPU and without ``--device cpu`` the
bench raises before any work, and no record carries an earlier
measurement (``last_tpu_measurement`` has no counterpart).

Watchdogs: a thread (``MPCIUM_BENCH_WATCHDOG_S``, default 2700 s, 0
disables) and a child process that shares stdout but not the GIL. When
one fires it prints the best record known (the run's own, or a zero
record with ``watchdog_timeout``, ``watchdog_s``, ``stage_reached`` and
``env``) and the run ends non-zero (exit 4): the thread through
``os._exit``, the child by killing its frozen parent. ``bench.py``
exits 0 there. A ``secondary_error`` or ``gg18_ot_mta_error`` stays in
the record as in ``bench.py`` and makes the exit code 1.

Env knobs (``bench.py``'s): MPCIUM_BENCH_B (default 1024 on the card, 2
on the CPU), MPCIUM_BENCH_RUNS (timed runs, default 1),
MPCIUM_BENCH_NO_SECONDARY=1 / MPCIUM_BENCH_SECONDARY=1,
MPCIUM_BENCH_NO_OT=1, MPCIUM_BENCH_WATCHDOG_S, MPCIUM_BENCH_B_SWEEP
("1024,4096" or "none"; unset on the card: ``DEFAULT_B_SWEEP``) and
MPCIUM_BENCH_SWEEP_TIMEOUT_S (each sweep point's deadline, default the
watchdog's, and never past what the watchdog leaves). Each sweep point
runs ``python -m mpcium_tpu_torch.bench`` in a child on the same
``--device`` with ``MPCIUM_BENCH_B_SWEEP=none`` (``bench.py`` pops the
knob, and its child on the chip then sweeps again), and lands in
``b_sweep`` as its sigs/s or a structured DNF ``{dnf, reason,
elapsed_s, env}``; a size the card cannot hold is a DNF with its reason,
never a smaller batch. Each stage writes a ``bench: stage`` line to
stderr, and a point cut by its deadline is asked for its stacks
(faulthandler, SIGUSR1) before it is killed: both end up in the reason.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import secrets
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

BASELINE_SIGS_PER_SEC = 10_000.0
METRIC = "secp256k1_2of3_gg18_sigs_per_sec"
WATCHDOG_EXIT = 4  # a watchdog fired
STAGE_ERROR_EXIT = 1  # a secondary_error or gg18_ot_mta_error in the record
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)

# Shared with the watchdog thread. "record" is the most complete result so
# far; "printed" flips once the flagship line has been flushed to stdout;
# "deadline" is the watchdog's (time.monotonic), "child" a running sweep point.
_STATE: dict = {"record": None, "printed": False, "stage": "init", "deadline": None,
                "child": None}
_T0 = time.monotonic()
SWEEP_MARGIN_S = 30.0  # a sweep point ends this long before the watchdog fires

# Default sweep on the card when MPCIUM_BENCH_B_SWEEP is unset (bench.py's
# ladder). A size that wedges or times out lands as a structured DNF.
DEFAULT_B_SWEEP = "1024,4096,8192,16384"


def _emit(record: dict) -> None:
    sys.stdout.write(json.dumps(record) + "\n")
    sys.stdout.flush()


def _stage(name: str) -> None:
    """Enter a stage; a line on stderr says which and when, so a sweep
    point cut by its deadline names where it was."""
    _STATE["stage"] = name
    sys.stderr.write(f"bench: stage {name} at {time.monotonic() - _T0:.1f}s\n")
    sys.stderr.flush()


def _kill_child() -> None:
    """End a running sweep point: its process group (the point and its own
    watchdog child)."""
    child = _STATE.get("child")
    if child is not None and child.poll() is None:
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except OSError:
            pass


def resolve_platform(device_arg: Optional[str]):
    """(torch device, "gpu" | "cpu") for ``--device``; None is the GPU, and
    it raises when there is none."""
    import torch

    from .device import resolve

    dev = resolve(device_arg)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device_arg}: no CUDA device is available")
    return dev, ("gpu" if dev.type == "cuda" else "cpu")


def _zero_record(platform: str, stage: str) -> dict:
    from .perf.envfp import env_fingerprint

    return {
        "metric": METRIC,
        "value": 0.0,
        "unit": "signatures/sec",
        "vs_baseline": 0.0,
        "platform": platform,
        "env": env_fingerprint(),
        "stage_reached": stage,
    }


# -- watchdogs ----------------------------------------------------------------


def _arm_watchdog(platform: str) -> Optional[subprocess.Popen]:
    """The thread watchdog, and the process child behind it; returns the
    child (None when disabled or not started)."""
    deadline = float(os.environ.get("MPCIUM_BENCH_WATCHDOG_S", "2700"))
    if deadline <= 0:
        return None
    _STATE["deadline"] = time.monotonic() + deadline

    def _fire() -> None:
        time.sleep(deadline)
        _kill_child()
        # whatever is emitted below is fresher than the process child's
        # arm-time record: stand it down
        _mark_flagship_printed()
        stage = _STATE["stage"]
        if _STATE["record"] is not None:
            # this run has a number: print it again (the main thread may
            # sit between setting "printed" and the write)
            _emit(_STATE["record"])
        elif not _STATE["printed"]:
            rec = _zero_record(platform, stage)
            rec.update({"watchdog_timeout": True, "watchdog_s": deadline,
                        "elapsed_s": round(deadline, 1)})
            _emit(rec)
        sys.stderr.write(f"bench: watchdog fired after {deadline:.0f}s in stage {stage}\n")
        sys.stderr.flush()
        os._exit(WATCHDOG_EXIT)

    threading.Thread(target=_fire, daemon=True, name="bench-watchdog").start()
    return _arm_process_watchdog(platform, deadline)


_SENTINEL = os.path.join(tempfile.gettempdir(), f".torch_bench_flagship_printed.{os.getpid()}")

_CHILD_SRC = r"""
import json, os, signal, sys, time
deadline = float(sys.argv[1]); sentinel = sys.argv[2]
ppid = int(sys.argv[3])


def parent_alive():
    try:
        os.kill(ppid, 0)
        return True
    except OSError:
        return False


def stood_down():
    if os.path.exists(sentinel):
        try:
            os.unlink(sentinel)
        except OSError:
            pass
        return True
    return False


t0 = time.time()
while time.time() - t0 < deadline:
    time.sleep(5)
    if stood_down():
        sys.exit(0)  # the parent printed the flagship line
    if not parent_alive():
        # the parent exited without a flagship line (a crash): a made-up
        # line would mask it, and holding the inherited stdout open would
        # block a driver reading to EOF -- leave silently
        sys.exit(0)
if stood_down() or not parent_alive():
    sys.exit(0)
# deadline reached with the parent alive and silent: it is frozen in
# native code holding the GIL -- print its record, then end it, so the
# run ends non-zero and nothing waits on it
rec = json.loads(os.environ["MPCIUM_BENCH_FALLBACK"])
rec["watchdog_timeout"] = True
rec["watchdog"] = "process"
rec["elapsed_s"] = round(time.time() - t0, 1)
sys.stdout.write(json.dumps(rec) + "\n")
sys.stdout.flush()
try:
    os.kill(ppid, signal.SIGKILL)
except OSError:
    pass
"""


def _arm_process_watchdog(platform: str, deadline: float) -> Optional[subprocess.Popen]:
    """Backstop for the thread watchdog: a child that shares our stdout
    but not our GIL (a call frozen in native code holding the GIL stops
    every python thread). It sleeps, checks the sentinel the parent
    writes after the flagship line, and otherwise prints the zero record
    stamped here and kills the parent."""
    rec = _zero_record(platform, "unknown (parent frozen in native code)")
    rec["watchdog_s"] = deadline
    env = dict(os.environ)
    env["MPCIUM_BENCH_FALLBACK"] = json.dumps(rec)
    env["PYTHONPATH"] = ""  # the child imports the standard library only
    try:
        os.unlink(_SENTINEL)  # a recycled-PID leftover would disarm it
    except OSError:
        pass
    try:
        return subprocess.Popen(
            [sys.executable, "-c", _CHILD_SRC, str(deadline), _SENTINEL, str(os.getpid())],
            env=env,
            stdout=None,  # inherited: the caller reads our stdout
            stderr=subprocess.DEVNULL,
        )
    except OSError:
        return None  # the thread watchdog stays the only backstop


def _stop_process_watchdog(child: Optional[subprocess.Popen]) -> None:
    if child is None:
        return
    if child.poll() is None:
        child.send_signal(signal.SIGTERM)
        try:
            child.wait(timeout=10)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
    try:
        os.unlink(_SENTINEL)
    except OSError:
        pass


def _mark_flagship_printed() -> None:
    try:
        with open(_SENTINEL, "w") as f:
            f.write("1")
    except OSError:
        pass


def _stop_host_pools() -> None:
    """Shut down the non-daemon host workers a cohorted sign
    (``pipe-host``) and the OT variant (``ot-host``) start, so that no
    sweep child or campaign step waits at exit on one."""
    mods = [sys.modules.get(__package__ + ".engine.pipeline"),
            sys.modules.get(__package__ + ".protocol.ecdsa.mta_ot")]
    for mod in mods:
        if mod is None:
            continue
        with mod._POOL_LOCK:
            pool, mod._HOST_POOL = mod._HOST_POOL, None
        if pool is not None:
            pool.shutdown(wait=True)


# -- the record ---------------------------------------------------------------


def k0_counts() -> dict:
    """K0's counters (``ops/mulmod``), read as ``compile_watch.export_gauges``
    reads them: launches by width, powmod launches by mode and width,
    plain calls."""
    from .ops import mulmod as K

    with K._count_lock:
        by_width = dict(K.launches_by_width)
        by_mode = dict(K.powmod_launches_by_mode_width)
        plain = K.plain_calls
    return {
        "launches": sum(by_width.values()) + sum(by_mode.values()),
        "mulmod_launches": {f"n{n}": v for n, v in sorted(by_width.items())},
        "powmod_launches": {f"{m}_n{n}": v for (m, n), v in sorted(by_mode.items())},
        "plain_calls": plain,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    dev, platform = resolve_platform(args.device)
    if hasattr(signal, "SIGUSR1"):
        # a sweep driver asks a point that ran out of time for its stacks
        try:
            faulthandler.register(signal.SIGUSR1, file=sys.__stderr__, all_threads=True)
        except (AttributeError, OSError, ValueError):
            pass  # no stderr file descriptor: no stack dump
    child = _arm_watchdog(platform)
    try:
        return run(dev, platform, args.device)
    finally:
        _stop_host_pools()
        _stop_process_watchdog(child)


def run(dev, platform: str, device_arg: Optional[str]) -> int:
    """The stages of ``bench.py``'s ``main`` on ``dev``; returns the exit
    code (1 when a secondary or OT stage failed)."""
    B = int(os.environ.get("MPCIUM_BENCH_B", "1024" if platform == "gpu" else "2"))
    runs = int(os.environ.get("MPCIUM_BENCH_RUNS", "1"))

    import numpy as np

    from .cluster import load_test_preparams
    from .engine import gg18_batch as gb
    from .ops import mulmod as K

    party_ids = ["node0", "node1", "node2"]
    _stage("setup")
    t0 = time.perf_counter()
    shares = gb.dealer_keygen_secp_batch(B, party_ids, threshold=1)
    preparams = load_test_preparams()
    signer = gb.GG18BatchCoSigners(party_ids[:2], shares[:2], preparams, rng=secrets,
                                   device=dev)
    setup_s = time.perf_counter() - t0
    digests = np.frombuffer(secrets.token_bytes(B * 32), dtype=np.uint8).reshape(B, 32)

    # warm-up: the first sign builds (or loads) K0 and the comb tables
    K.reset_counters()
    _stage("compile")
    t0 = time.perf_counter()
    out = signer.sign(digests)
    compile_s = time.perf_counter() - t0
    assert out["ok"].all(), "warmup GG18 signatures invalid"

    # one phase-profiled run on the card: the engine's spans, folded into
    # the phase table; MPCIUM_PROFILE=1 also captures the device timeline
    phases: dict = {}
    profiled_s = 0.0
    idle_fraction = 0.0
    if platform == "gpu":
        from .perf import profile as perf_profile
        from .utils import tracing

        _stage("profiled_run")
        spans: list = []
        logdir = os.path.join(perf_profile.default_logdir(_ROOT), f"bench_{os.getpid()}")
        shutil.rmtree(logdir, ignore_errors=True)  # fold_device_ops reads every capture there
        tracing.enable(sink=spans.append)
        try:
            with perf_profile.device_profile(logdir, device=dev) as profiling:
                t0 = time.perf_counter()
                out = signer.sign(digests)
                profiled_s = time.perf_counter() - t0
        finally:
            tracing.disable()
        assert out["ok"].all()
        phases = tracing.phase_share(spans)
        idle_fraction = tracing.device_idle_fraction(spans)
        if profiling:
            phases.update(perf_profile.fold_device_ops(spans, logdir))

    _stage("timed_run")
    t0 = time.perf_counter()
    for _ in range(runs):
        out = signer.sign(digests)
        assert out["ok"].all()
    elapsed = time.perf_counter() - t0

    from .engine.pipeline import resolve_cohorts
    from .perf import compile_watch
    from .perf.envfp import env_fingerprint

    sigs_per_sec = runs * B / elapsed
    record = {
        "metric": METRIC,
        "value": round(sigs_per_sec, 3),
        "unit": "signatures/sec",
        "vs_baseline": round(sigs_per_sec / BASELINE_SIGS_PER_SEC, 4),
        "platform": platform,
        "batch": B,
        "pipeline_cohorts": resolve_cohorts(B),
        "runs": runs,
        "mta": os.environ.get("MPCIUM_MTA", "paillier"),
        "setup_s": round(setup_s, 1),
        "compile_s": round(compile_s, 1),
        "profiled_run_s": round(profiled_s, 1),
        "device_idle_fraction": round(idle_fraction, 4),
        "phase_s": {k: round(v, 2) for k, v in phases.items()},
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
    }
    record["env"] = env_fingerprint()
    record["compile"] = compile_watch.health_summary()
    record["k0"] = k0_counts()
    # print the flagship line NOW: what follows must not cost the number.
    # "printed" flips before the write, so a watchdog firing inside the
    # window prints this record again rather than a staler one after it
    _STATE["record"] = dict(record)
    _STATE["printed"] = True
    _emit(record)
    _mark_flagship_printed()
    rc = 0

    # secondary metrics (BASELINE configs 2, 4, 5): by default on the card
    want_secondary = (
        os.environ.get("MPCIUM_BENCH_SECONDARY") == "1"
        or (platform == "gpu" and not os.environ.get("MPCIUM_BENCH_NO_SECONDARY"))
    )
    if want_secondary:
        _stage("secondary")
        try:
            extra = _secondary_metrics(B, dev)
        except Exception as e:  # noqa: BLE001 — the flagship line is already out
            extra = {"secondary_error": repr(e)}
            rc = STAGE_ERROR_EXIT
        if extra:
            record.update(extra)
            _STATE["record"] = dict(record)
            _emit(record)

    # the OT-MtA variant (MPCIUM_MTA=ot), a labelled extra beside the
    # Paillier flagship
    if (platform == "gpu"
            and os.environ.get("MPCIUM_MTA", "paillier") == "paillier"
            and not os.environ.get("MPCIUM_BENCH_NO_OT")):
        _stage("ot_variant")
        if not _ot_variant(record, party_ids, shares, preparams, digests, B, dev):
            rc = STAGE_ERROR_EXIT
        _STATE["record"] = dict(record)
        _emit(record)

    _run_b_sweep(record, device_arg)
    return rc


def _ot_variant(record: dict, party_ids, shares, preparams, digests, B: int, dev) -> bool:
    """The OT-MtA signer's sigs/s, its traced phase table with the host /
    device / overlap split, and the checks-on/off A/B under
    ``MPCIUM_OT_CHECKS=0``. ``MPCIUM_MTA`` is read per signer and
    ``MPCIUM_OT_CHECKS`` per call; both are restored. False when it
    failed (``gg18_ot_mta_error`` in the record)."""
    from .engine import gg18_batch as gb
    from .utils import tracing

    prev_mta = os.environ.get("MPCIUM_MTA")
    try:
        os.environ["MPCIUM_MTA"] = "ot"
        signer_ot = gb.GG18BatchCoSigners(party_ids[:2], shares[:2], preparams, rng=secrets,
                                          device=dev)
        out = signer_ot.sign(digests)  # warm-up
        assert out["ok"].all()
        t0 = time.perf_counter()
        out = signer_ot.sign(digests)
        assert out["ok"].all()
        checked_s = time.perf_counter() - t0
        record["gg18_ot_mta_sigs_per_sec"] = round(B / checked_s, 3)
        record["gg18_ot_mta_batch"] = B
        spans_ot: list = []
        tracing.enable(sink=spans_ot.append)
        try:
            out = signer_ot.sign(digests)
        finally:
            tracing.disable()
        assert out["ok"].all()
        phases_ot = tracing.phase_share(spans_ot)
        record["gg18_ot_mta_phase_s"] = {k: round(v, 3) for k, v in phases_ot.items()}
        record["gg18_ot_mta_device_idle_fraction"] = round(
            tracing.device_idle_fraction(spans_ot), 4)
        record["gg18_ot_mta_host_s"] = round(phases_ot.get("r2_mta_ot_host", 0.0), 3)
        record["gg18_ot_mta_device_s"] = round(phases_ot.get("r2_mta_ot_device", 0.0), 3)
        record["gg18_ot_mta_overlap_ratio"] = round(
            phases_ot.get("r2_mta_ot_overlap_ratio", 0.0), 3)
        record["gg18_ot_mta_chunks"] = int(phases_ot.get("r2_mta_ot_chunks", 1))
        prev_checks = os.environ.get("MPCIUM_OT_CHECKS")
        os.environ["MPCIUM_OT_CHECKS"] = "0"
        try:
            out = signer_ot.sign(digests)  # warm-up of the passive path
            assert out["ok"].all()
            t0 = time.perf_counter()
            out = signer_ot.sign(digests)
            assert out["ok"].all()
            passive_s = time.perf_counter() - t0
        finally:
            if prev_checks is None:
                os.environ.pop("MPCIUM_OT_CHECKS", None)
            else:
                os.environ["MPCIUM_OT_CHECKS"] = prev_checks
        record["gg18_ot_checks_on_s"] = round(checked_s, 3)
        record["gg18_ot_checks_off_s"] = round(passive_s, 3)
        record["gg18_ot_checks_s"] = round(checked_s - passive_s, 3)
        return True
    except Exception as e:  # noqa: BLE001 — the flagship line is already out
        record["gg18_ot_mta_error"] = repr(e)
        return False
    finally:
        if prev_mta is None:
            os.environ.pop("MPCIUM_MTA", None)
        else:
            os.environ["MPCIUM_MTA"] = prev_mta


# -- the batch sweep ----------------------------------------------------------


def _parse_last_metric_line(stdout: bytes) -> Optional[dict]:
    for line in reversed(stdout.decode(errors="replace").splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and "metric" in doc:
            return doc
    return None


def child_argv(device_arg: Optional[str]) -> list:
    """The command of one sweep point: this module, on the parent's device."""
    argv = [sys.executable, "-m", __package__ + ".bench"]
    if device_arg is not None:
        argv += ["--device", str(device_arg)]
    return argv


def _b_sweep_entry(bsz: int, timeout_s: float, device_arg: Optional[str] = None,
                   argv: Optional[list] = None) -> object:
    """One sweep point: this bench in a child at batch ``bsz``. Returns
    the measured sigs/s (float) or a structured DNF
    ``{"dnf": True, "reason", "elapsed_s", "env"}``. ``argv`` replaces the
    child's command (tests)."""
    env = dict(os.environ)
    # no recursive sweeps: bench.py pops the knob, and a child on the chip
    # then runs the default sweep itself; "none" turns it off
    env["MPCIUM_BENCH_B_SWEEP"] = "none"
    env["MPCIUM_BENCH_B"] = str(bsz)
    # sweep points measure the flagship metric only
    env["MPCIUM_BENCH_NO_SECONDARY"] = "1"
    env["MPCIUM_BENCH_NO_OT"] = "1"
    # the child finds this package from the repo root
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH", "")) if p)

    from .perf.envfp import env_fingerprint

    t0 = time.time()

    def _dnf(reason: str) -> dict:
        return {
            "dnf": True,
            "reason": reason,
            "elapsed_s": round(time.time() - t0, 1),
            "env": env_fingerprint(),
        }

    r = _STATE["child"] = subprocess.Popen(
        argv or child_argv(device_arg), env=env, cwd=_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        stdout, stderr = r.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        # ask for its stacks (faulthandler on SIGUSR1), then end its group
        try:
            r.send_signal(getattr(signal, "SIGUSR1", signal.SIGTERM))
            time.sleep(2.0)
            os.killpg(r.pid, signal.SIGKILL)
        except OSError:
            pass
        _out, stderr = r.communicate()
        return _dnf(f"no metric line within {timeout_s:.0f}s — killed by sweep driver"
                    + _stderr_note(stderr))
    finally:
        _STATE["child"] = None
    doc = _parse_last_metric_line(stdout)
    if doc is None:
        return _dnf(f"rc={r.returncode} with no parseable metric line" + _stderr_note(stderr))
    if doc.get("watchdog_timeout"):
        return _dnf(
            f"watchdog fired at {doc.get('watchdog_s', '?')}s "
            f"(stage: {doc.get('stage_reached', 'unknown')})"
        )
    value = doc.get("value")
    if isinstance(value, (int, float)) and value > 0:
        return round(float(value), 3)
    return _dnf(f"rc={r.returncode} with non-positive value {value!r}")


def _stderr_note(stderr: bytes) -> str:
    """The point's last stage line and the end of its stderr (a traceback
    or a stack dump), for a DNF's reason."""
    text = stderr.decode(errors="replace")
    if not text.strip():
        return ""
    stages = [ln for ln in text.splitlines() if ln.startswith("bench: stage ")]
    note = f" (last {stages[-1][len('bench: '):]})" if stages else ""
    return note + " — stderr: " + " | ".join(text.strip().splitlines()[-8:])[-600:]


def sweep_points(spec: str) -> list:
    """The batch sizes of a sweep spec, snapped to the bucket grid
    (``engine/buckets.bucket_b``), duplicates dropped, in order."""
    from .engine.buckets import bucket_b

    out: list = []
    for tok in spec.split(","):
        tok = tok.strip()
        if tok and bucket_b(int(tok)) not in out:
            out.append(bucket_b(int(tok)))
    return out


def _run_b_sweep(record: dict, device_arg: Optional[str]) -> None:
    """MPCIUM_BENCH_B_SWEEP: batch sizes, each timed in its own child;
    results land under record["b_sweep"] keyed by batch size. Unset on the
    card → ``DEFAULT_B_SWEEP``; "0"/"none" disables."""
    spec = os.environ.get("MPCIUM_BENCH_B_SWEEP", "").strip()
    if not spec and record.get("platform") == "gpu":
        spec = DEFAULT_B_SWEEP
    if not spec or spec.lower() in ("0", "none"):
        return
    from .perf.envfp import env_fingerprint

    _stage("b_sweep")
    timeout_s = float(os.environ.get(
        "MPCIUM_BENCH_SWEEP_TIMEOUT_S",
        os.environ.get("MPCIUM_BENCH_WATCHDOG_S", "2700"),
    ))
    sweep: dict = {}
    for bsz in sweep_points(spec):
        # a point ends before the watchdog would: its DNF is data, the
        # watchdog firing would cost the whole record
        budget = timeout_s
        if _STATE["deadline"] is not None:
            budget = min(budget, _STATE["deadline"] - time.monotonic() - SWEEP_MARGIN_S)
        if budget <= 0:
            sweep[str(bsz)] = {"dnf": True, "elapsed_s": 0.0, "env": env_fingerprint(),
                               "reason": "not run: the watchdog's deadline leaves no time"}
        else:
            sweep[str(bsz)] = _b_sweep_entry(bsz, budget, device_arg)
        # partial progress beats an empty field if a later size wedges
        record["b_sweep"] = dict(sweep)
        _STATE["record"] = dict(record)
    _emit(record)


# -- BASELINE configs 2, 4, 5 ---------------------------------------------------


def _secondary_metrics(B: int, dev) -> dict:
    """EdDSA signing at max(B, 4096) (B below 256 as given), batched DKG at
    B, batched reshare 2-of-3 → 3-of-5 at B/4; each timed warm, after a
    first run at the same shape."""
    import secrets as sec

    from .engine import eddsa_batch as eb
    from .engine.dkg_batch import BatchedDKG, BatchedReshare

    out = {}
    ids = ["node0", "node1", "node2"]

    Be = max(B, 4096) if B >= 256 else B
    shares = eb.dealer_keygen_batch(Be, ids, 1, rng=sec)
    signer = eb.BatchedCoSigners(ids[:2], shares[:2], rng=sec, device=dev)
    messages = [sec.token_bytes(32) for _ in range(Be)]
    sigs, ok = signer.sign(messages)  # warm-up
    assert ok.all()
    t0 = time.perf_counter()
    sigs, ok = signer.sign(messages)
    out["ed25519_2of3_sigs_per_sec"] = round(Be / (time.perf_counter() - t0), 1)
    assert ok.all()
    out["ed25519_batch"] = Be

    dkg = BatchedDKG(ids, threshold=1, key_type="secp256k1", rng=sec, device=dev)
    dkg.run(B)  # warm-up at the timed shape
    t0 = time.perf_counter()
    dshares = dkg.run(B)
    out["secp256k1_dkg_wallets_per_sec"] = round(B / (time.perf_counter() - t0), 1)
    out["dkg_batch"] = B

    Br = max(B // 4, 1)
    rs = BatchedReshare(
        ids[:2], [dshares[0][:Br], dshares[1][:Br]],
        ["node0", "node1", "node2", "node3", "node4"], new_threshold=2,
        rng=sec, device=dev,
    )
    rs.run()  # warm-up at the timed shape
    t0 = time.perf_counter()
    rs.run()
    out["reshare_2of3_to_3of5_wallets_per_sec"] = round(Br / (time.perf_counter() - t0), 1)
    out["reshare_batch"] = Br
    return out


if __name__ == "__main__":
    raise SystemExit(main())
