"""The port's bench (``mpcium_tpu_torch/bench.py``) against the repo-root
``bench.py``: the metric-line parse, the sweep's points and its DNF
shapes, the flagship record's keys (from stub signers, no live sign), the
stages' env flips, the exit codes, the refusal without a GPU, and the
watchdogs (slow: real sleeping subprocesses)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from mpcium_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench as jbench  # noqa: E402  (the repo-root bench.py: stdlib at module level)


PARSE_TABLE = [
    b"",
    b"warming up\n",
    b'{"metric": "m", "value": 1.5}\n',
    b'{"metric": "m", "value": 1.5}\n{"metric": "m", "value": 2.5, "b_sweep": {}}\n',
    b'{"metric": "m", "value": 1.5}\nnoise after\n',
    b'{"metric": "m", "value": 1.5}\n{"no_metric": 1}\n',
    b'{"metric": "m", "value": 1.5}\n{"metric": broken\n',
    b'  {"metric": "indented", "value": 3}  \n',
    b'[1, 2, 3]\n{"metric": "m", "value": 4}\n[4]\n',
    b'{"metric": "m", "value": 5}\n\xff\xfe not utf-8\n',
    b'{"metric": "m", "value": 0.0, "watchdog_timeout": true}\n',
    b'"{\\"metric\\": 1}"\n',
]


@pytest.mark.parametrize("stdout", PARSE_TABLE, ids=range(len(PARSE_TABLE)))
def test_parse_last_metric_line_equals_bench_py(stdout):
    assert bench._parse_last_metric_line(stdout) == jbench._parse_last_metric_line(stdout)


@pytest.mark.parametrize("spec", [jbench.DEFAULT_B_SWEEP, "1,2,3,1000,1024", "5000, 4096,,9000",
                                  "100000", "16"])
def test_sweep_points_snap_as_bench_py(spec):
    from mpcium_tpu.engine.buckets import bucket_b

    want: list = []
    for tok in spec.split(","):
        tok = tok.strip()
        if tok and bucket_b(int(tok)) not in want:
            want.append(bucket_b(int(tok)))
    assert bench.sweep_points(spec) == want
    assert bench.DEFAULT_B_SWEEP == jbench.DEFAULT_B_SWEEP == "1024,4096,8192,16384"
    assert bench.sweep_points(bench.DEFAULT_B_SWEEP) == [1024, 4096, 8192, 16384]


_CHILD_OUT = {
    "no_metric": b"warming up\n",
    "nonpositive": b'{"metric": "m", "value": 0.0}\n',
    "watchdog": json.dumps({"metric": "m", "value": 0.0, "watchdog_timeout": True,
                            "watchdog_s": 7.0, "stage_reached": "compile"}).encode(),
    "ok": b'{"metric": "m", "value": 12.34567}\n',
}


def _fake_run(kind):
    """bench.py's subprocess.run, answering as a child of ``kind`` would."""
    def run(argv, **kw):
        if kind == "timeout":
            raise subprocess.TimeoutExpired(argv, kw.get("timeout"))
        return subprocess.CompletedProcess(argv, 3 if kind != "ok" else 0, _CHILD_OUT[kind], b"")
    return run


class _FakePopen:
    """The port's sweep child, answering as a child of ``kind`` would."""
    kind = "ok"

    def __init__(self, argv, **kw):
        self.pid = -1
        self.returncode = 3 if self.kind != "ok" else 0
        self._timed_out = False

    def communicate(self, timeout=None):
        if self.kind == "timeout" and not self._timed_out:
            self._timed_out = True
            raise subprocess.TimeoutExpired("child", timeout)
        return (b"" if self.kind == "timeout" else _CHILD_OUT[self.kind]), b""

    def send_signal(self, sig):
        pass

    def poll(self):
        return self.returncode


@pytest.mark.parametrize("kind", ["timeout", "no_metric", "nonpositive", "watchdog", "ok"])
def test_sweep_entry_shapes_equal_bench_py(kind, monkeypatch):
    monkeypatch.setattr(subprocess, "run", _fake_run(kind))
    monkeypatch.setattr(_FakePopen, "kind", kind)
    monkeypatch.setattr(subprocess, "Popen", _FakePopen)
    monkeypatch.setattr(os, "killpg", lambda pid, sig: None)
    got = bench._b_sweep_entry(4096, 5.0, "cpu")
    want = jbench._b_sweep_entry(4096, 5.0)
    if kind == "ok":
        assert got == want == 12.346
        return
    assert sorted(got) == sorted(want) == ["dnf", "elapsed_s", "env", "reason"]
    assert got["dnf"] is True and got["reason"] == want["reason"]
    assert got["env"]["platform"] in ("gpu", "cpu", "uninitialized")


def test_sweep_entry_runs_a_real_child_and_times_it_out(tmp_path):
    slow = [sys.executable, "-c", "import time; time.sleep(30)"]
    t0 = time.monotonic()
    dnf = bench._b_sweep_entry(8, 1.0, argv=slow)
    assert time.monotonic() - t0 < 20
    assert dnf["dnf"] and "killed by sweep driver" in dnf["reason"]
    crash = [sys.executable, "-c", "import sys; sys.stderr.write('bench: stage setup at 0.1s\\n"
             "CUDA out of memory\\n'); raise SystemExit(1)"]
    dnf = bench._b_sweep_entry(8, 30.0, argv=crash)
    assert dnf["reason"].startswith("rc=1 with no parseable metric line (last stage setup")
    assert "CUDA out of memory" in dnf["reason"]
    # a point cut by its deadline names its stage and leaves its stacks in the reason
    hang = [sys.executable, "-c", "import faulthandler, signal, sys, time; "
            "faulthandler.register(signal.SIGUSR1, all_threads=True); "
            "sys.stderr.write('bench: stage compile at 0.2s\\n'); sys.stderr.flush(); "
            "time.sleep(60)"]
    dnf = bench._b_sweep_entry(8, 3.0, argv=hang)
    assert "killed by sweep driver (last stage compile" in dnf["reason"]
    assert "time.sleep(60)" in dnf["reason"] or "File" in dnf["reason"]
    assert bench._STATE["child"] is None
    # the point measures the flagship only, and never sweeps itself (the
    # default sweep would start again in a child on the card)
    env_check = [sys.executable, "-c", "import json, os; e = os.environ; "
                 "ok = (e['MPCIUM_BENCH_B_SWEEP'] == 'none' and e['MPCIUM_BENCH_NO_OT'] == '1' "
                 "and e['MPCIUM_BENCH_NO_SECONDARY'] == '1'); "
                 "print(json.dumps({'metric': 'm', 'value': float(e['MPCIUM_BENCH_B']) * ok}))"]
    assert bench._b_sweep_entry(8, 30.0, argv=env_check) == 8.0
    argv = bench.child_argv("cpu")
    assert argv[1:] == ["-m", "mpcium_tpu_torch.bench", "--device", "cpu"]


# -- the flagship record from stub signers -----------------------------------------


class _StubSigner:
    """Stands in for GG18BatchCoSigners: the MtA it was built under and the
    MPCIUM_OT_CHECKS each sign saw."""
    made: list = []

    def __init__(self, party_ids, shares, preparams=None, rng=None, device=None, **kw):
        self.B = len(shares[0])
        self.mta = os.environ.get("MPCIUM_MTA", "paillier")
        self.checks_seen: list = []
        _StubSigner.made.append(self)

    def sign(self, digests, phase_times=None, cohorts=None):
        from mpcium_tpu_torch.utils import tracing

        assert digests.shape == (self.B, 32)
        self.checks_seen.append(os.environ.get("MPCIUM_OT_CHECKS"))
        t0 = tracing.now_ns()
        tracing.emit("phase:r1_commit", t0, t0 + 1000, node="engine", tid="stub")
        return {"ok": np.ones(self.B, dtype=bool)}


class _StubEdSigner:
    def __init__(self, ids, shares, rng=None, device=None):
        self.B = len(shares[0])

    def sign(self, messages, cohorts=None):
        return np.zeros((self.B, 64), np.uint8), np.ones(self.B, dtype=bool)


class _StubDKG:
    def __init__(self, ids, threshold, key_type, rng=None, device=None):
        self.n = len(ids)

    def run(self, B, cohorts=None):
        return [[object()] * B for _ in range(self.n)]


class _StubReshare:
    def __init__(self, old_quorum, old_shares, new_committee, new_threshold, rng=None,
                 device=None):
        assert len(old_quorum) == 2 and len(new_committee) == 5 and new_threshold == 2

    def run(self, cohorts=None):
        return []


@pytest.fixture
def stub_engines(monkeypatch):
    import torch

    from mpcium_tpu_torch import cluster
    from mpcium_tpu_torch.engine import dkg_batch, eddsa_batch
    from mpcium_tpu_torch.engine import gg18_batch as gb

    _StubSigner.made = []
    monkeypatch.setattr(gb, "dealer_keygen_secp_batch",
                        lambda B, ids, threshold: [[object()] * B for _ in ids])
    monkeypatch.setattr(gb, "GG18BatchCoSigners", _StubSigner)
    monkeypatch.setattr(cluster, "load_test_preparams", lambda bits=2048: {})
    monkeypatch.setattr(eddsa_batch, "dealer_keygen_batch",
                        lambda B, ids, t, rng=None: [[object()] * B for _ in ids])
    monkeypatch.setattr(eddsa_batch, "BatchedCoSigners", _StubEdSigner)
    monkeypatch.setattr(dkg_batch, "BatchedDKG", _StubDKG)
    monkeypatch.setattr(dkg_batch, "BatchedReshare", _StubReshare)
    # the stages bench.py runs only on the chip run on "gpu": stub the card
    monkeypatch.setattr(bench, "resolve_platform", lambda arg: (torch.device("cpu"), "gpu"))
    for k in ("MPCIUM_MTA", "MPCIUM_BENCH_NO_SECONDARY", "MPCIUM_BENCH_NO_OT",
              "MPCIUM_BENCH_SECONDARY", "MPCIUM_PROFILE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MPCIUM_BENCH_B", "4")
    monkeypatch.setenv("MPCIUM_BENCH_B_SWEEP", "none")
    monkeypatch.setenv("MPCIUM_BENCH_WATCHDOG_S", "0")
    monkeypatch.setenv("MPCIUM_OT_CHECKS", "1")
    bench._STATE.update({"record": None, "printed": False, "stage": "init"})
    yield


def _records(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_flagship_record_covers_bench_py_record(stub_engines, capsys):
    rc = bench.main(["--device", "cpu"])
    recs = _records(capsys.readouterr().out)
    assert rc == 0
    # the flagship line, then the secondary and the OT variant merged in
    assert len(recs) == 3 and all(r["metric"] == bench.METRIC for r in recs)
    final = recs[-1]
    committed = json.loads((ROOT / "BENCH_TPU_LATEST.json").read_text())
    missing = sorted(set(committed) - set(final))
    assert not missing, missing
    assert final["platform"] == "gpu" and final["batch"] == 4 and final["value"] > 0
    assert final["mta"] == "paillier"
    assert {"env", "compile", "k0", "device_idle_fraction", "pipeline_cohorts"} <= set(final)
    assert sorted(final["k0"]) == ["launches", "mulmod_launches", "plain_calls",
                                   "powmod_launches"]
    assert final["phase_s"] == {"r1_commit": 0.0}
    for key in ("gg18_ot_checks_on_s", "gg18_ot_checks_off_s", "gg18_ot_checks_s",
                "gg18_ot_mta_host_s", "gg18_ot_mta_device_s", "gg18_ot_mta_overlap_ratio",
                "gg18_ot_mta_chunks", "gg18_ot_mta_device_idle_fraction", "gg18_ot_mta_phase_s"):
        assert key in final, key
    assert final["ed25519_batch"] == 4 and final["dkg_batch"] == 4 and final["reshare_batch"] == 1
    assert not [k for k in final if k.startswith("last_tpu_measurement")]
    # the Paillier flagship and one OT signer; the OT signer's last two signs
    # ran with the checks off, and both env knobs are back as they were
    paillier, ot = _StubSigner.made
    assert paillier.mta == "paillier" and ot.mta == "ot"
    assert ot.checks_seen == ["1", "1", "1", "0", "0"]
    assert "MPCIUM_MTA" not in os.environ and os.environ["MPCIUM_OT_CHECKS"] == "1"


def test_stage_errors_stay_in_the_record_and_exit_one(stub_engines, monkeypatch, capsys):
    def boom(*a, **kw):
        raise RuntimeError("secondary down")

    monkeypatch.setattr(bench, "_secondary_metrics", boom)
    monkeypatch.setenv("MPCIUM_MTA", "paillier")
    rc = bench.main(["--device", "cpu"])
    final = _records(capsys.readouterr().out)[-1]
    assert rc == 1
    assert final["secondary_error"] == "RuntimeError('secondary down')"
    assert final["value"] > 0 and "gg18_ot_mta_sigs_per_sec" in final
    assert os.environ["MPCIUM_MTA"] == "paillier"


def test_cpu_platform_skips_what_bench_py_runs_only_on_chip(stub_engines, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(bench, "resolve_platform", lambda arg: (torch.device("cpu"), "cpu"))
    monkeypatch.delenv("MPCIUM_BENCH_B_SWEEP")
    assert bench.main(["--device", "cpu"]) == 0
    recs = _records(capsys.readouterr().out)
    assert len(recs) == 1 and recs[0]["platform"] == "cpu"
    assert recs[0]["profiled_run_s"] == 0.0 and recs[0]["phase_s"] == {}
    assert "b_sweep" not in recs[0] and "gg18_ot_mta_sigs_per_sec" not in recs[0]
    assert [s.mta for s in _StubSigner.made] == ["paillier"]


def test_sweep_lands_points_and_dnfs_in_the_record(stub_engines, monkeypatch, capsys):
    seen = []

    def entry(bsz, timeout_s, device_arg=None, argv=None):
        seen.append((bsz, timeout_s, device_arg))
        return 7.5 if bsz < 8 else {"dnf": True, "reason": "too big", "elapsed_s": 0.1, "env": {}}

    monkeypatch.setattr(bench, "_b_sweep_entry", entry)
    monkeypatch.setenv("MPCIUM_BENCH_B_SWEEP", "3,4,8")
    monkeypatch.setenv("MPCIUM_BENCH_SWEEP_TIMEOUT_S", "123")
    monkeypatch.setenv("MPCIUM_BENCH_NO_OT", "1")
    monkeypatch.setenv("MPCIUM_BENCH_NO_SECONDARY", "1")
    assert bench.main(["--device", "cpu"]) == 0
    final = _records(capsys.readouterr().out)[-1]
    assert seen == [(4, 123.0, "cpu"), (8, 123.0, "cpu")]
    assert final["b_sweep"] == {"4": 7.5, "8": {"dnf": True, "reason": "too big",
                                                "elapsed_s": 0.1, "env": {}}}


def test_the_bench_raises_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError):
            bench.main(argv)
    r = subprocess.run([sys.executable, "-m", "mpcium_tpu_torch.bench"], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, MPCIUM_BENCH_WATCHDOG_S="5"))
    assert r.returncode != 0 and r.stdout == ""
    assert "none is available" in r.stderr


def test_the_bench_keeps_no_cpu_fallback_and_no_earlier_measurement():
    src = (ROOT / "mpcium_tpu_torch" / "bench.py").read_text()
    for gone in ("_ensure_backend", "_probe_tpu", "_load_last_tpu_record", "_cache_dir",
                 "os.execve", "JAX_PLATFORMS", "BENCH_TPU_LATEST"):
        assert gone not in src, gone
    assert bench.WATCHDOG_EXIT != 0 and bench.STAGE_ERROR_EXIT != 0


# -- the watchdogs (real subprocesses, seconds of sleep) -----------------------------


def _spawn_child(tmp_path, deadline, ppid, record=None):
    sentinel = str(tmp_path / "sentinel")
    env = dict(os.environ)
    env["MPCIUM_BENCH_FALLBACK"] = json.dumps(record or {"metric": "m", "value": 0.0})
    env["PYTHONPATH"] = ""
    p = subprocess.Popen(
        [sys.executable, "-c", bench._CHILD_SRC, str(deadline), sentinel, str(ppid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    return p, sentinel


@pytest.mark.slow
def test_watchdog_child_stands_down_on_sentinel(tmp_path):
    p, sentinel = _spawn_child(tmp_path, deadline=60, ppid=os.getpid())
    with open(sentinel, "w") as f:
        f.write("1")
    out, _ = p.communicate(timeout=30)
    assert out == "" and p.returncode == 0
    assert not os.path.exists(sentinel)


@pytest.mark.slow
def test_watchdog_child_exits_silently_when_parent_dies(tmp_path):
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait(timeout=30)
    p, _ = _spawn_child(tmp_path, deadline=60, ppid=dead.pid)
    out, _ = p.communicate(timeout=30)
    assert out == "" and p.returncode == 0


@pytest.mark.slow
def test_watchdog_child_prints_and_kills_a_frozen_parent(tmp_path):
    frozen = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    try:
        rec = {"metric": bench.METRIC, "value": 0.0, "stage_reached": "unknown"}
        p, _ = _spawn_child(tmp_path, deadline=6, ppid=frozen.pid, record=rec)
        out, _ = p.communicate(timeout=60)
        line = json.loads(out.strip())
        assert line["value"] == 0.0 and line["watchdog_timeout"] is True
        assert line["watchdog"] == "process"
        assert frozen.wait(timeout=30) != 0  # killed: the run ends non-zero
    finally:
        if frozen.poll() is None:
            frozen.kill()
            frozen.wait()


@pytest.mark.slow
def test_thread_watchdog_prints_a_zero_record_and_exits_nonzero(tmp_path):
    code = ("import time; from mpcium_tpu_torch import bench; "
            "bench._STATE['stage'] = 'compile'; child = bench._arm_watchdog('cpu'); "
            "time.sleep(60)")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                       text=True, timeout=60, env=dict(os.environ, MPCIUM_BENCH_WATCHDOG_S="3"))
    assert r.returncode == bench.WATCHDOG_EXIT
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["watchdog_timeout"] is True
    assert line["watchdog_s"] == 3.0 and line["stage_reached"] == "compile"
    assert "env" in line and "watchdog fired" in r.stderr
