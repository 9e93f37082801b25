"""The port's campaign runner (``mpcium_tpu_torch/perf/campaign.py``) and
round driver (``scripts/torch_gpu_round.py``) against the JAX package's:
every case of ``tests/test_campaign_resume.py`` (SIGKILL the real runner
mid-step and resume, the torn tail, a corrupt middle line, a state file
of another plan, a dependency's DNF, a step's timeout, the platform the
report inherits), then the plan fingerprint, the state lines, the
heartbeat, the report and the lifted metrics equal to JAX's runner on the
same steps, the rehearsal and live plans, and the report's name."""
from __future__ import annotations

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from mpcium_tpu.perf import campaign as jcampaign
from mpcium_tpu_torch.perf import campaign

pytestmark = pytest.mark.perf

_ROOT = Path(__file__).resolve().parents[1]
_DRIVER = str(_ROOT / "scripts" / "torch_gpu_round.py")


def _round_module():
    spec = importlib.util.spec_from_file_location("torch_gpu_round", _DRIVER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plan(dirpath: Path, sleep_s: float = 0.0) -> Path:
    """Three trivial steps; s1/s2 bump run-counter files so a test can
    prove exactly which steps re-ran across a kill."""
    c1, c2 = dirpath / "s1.runs", dirpath / "s2.runs"
    mark2 = dirpath / "s2.started"
    steps = [
        {"id": "s1", "argv": [
            sys.executable, "-c",
            f"import json; open({str(c1)!r}, 'a').write('x\\n'); "
            f"print(json.dumps({{'v': 1, 'alpha_per_sec': 10.0}}))",
        ], "timeout_s": 60},
        {"id": "s2", "argv": [
            sys.executable, "-c",
            f"import json, time; open({str(mark2)!r}, 'a').write('s\\n'); "
            f"open({str(c2)!r}, 'a').write('x\\n'); "
            f"time.sleep({sleep_s}); print(json.dumps({{'v': 2}}))",
        ], "timeout_s": 60},
        {"id": "s3", "argv": [
            sys.executable, "-c",
            "import json; print(json.dumps({'v': 3}))",
        ], "needs": ["s2"], "timeout_s": 60},
    ]
    path = dirpath / "plan.json"
    path.write_text(json.dumps(steps))
    return path


def _invoke(plan: Path, state: Path, out: Path, **popen_kw):
    argv = [sys.executable, _DRIVER, "--plan", str(plan),
            "--state", str(state), "--out", str(out), "--no-ingest",
            "--heartbeat", str(state.parent / "hb.prom")]
    return subprocess.Popen(
        argv, cwd=str(_ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, **popen_kw,
    )


def _wait_for(path: Path, timeout=60.0):
    t0 = time.monotonic()
    while not path.exists():
        assert time.monotonic() - t0 < timeout, f"{path} never appeared"
        time.sleep(0.05)


def _strip_volatile(doc):
    """Everything wall-clock or host-dependent, so two runs of the same
    plan compare equal on content."""
    drop = {"elapsed_s", "_elapsed_s", "measured_at", "env", "plan_fp", "comment",
            "t0_ns", "t1_ns"}
    if isinstance(doc, dict):
        return {k: _strip_volatile(v) for k, v in doc.items() if k not in drop}
    if isinstance(doc, list):
        return [_strip_volatile(v) for v in doc]
    return doc


# -- JAX's tests/test_campaign_resume.py, against the port ------------------------


def test_resume_skips_finished_steps_and_reruns_killed_one(tmp_path):
    run_dir = tmp_path / "resume"
    run_dir.mkdir()
    plan = _plan(run_dir, sleep_s=2.0)
    state, out = run_dir / "state.jsonl", run_dir / "report.json"

    p = _invoke(plan, state, out)
    try:
        _wait_for(run_dir / "s2.started")
        time.sleep(0.2)
        os.kill(p.pid, signal.SIGKILL)
    finally:
        p.wait(timeout=30)
    assert not out.exists(), "killed run must not have written a report"
    assert list(campaign.load_state(str(state))["results"]) == ["s1"]

    p = _invoke(plan, state, out)
    stdout, _ = p.communicate(timeout=120)
    assert p.returncode == 0, stdout
    assert "[s1] already finished — skipping (resume)" in stdout
    assert (run_dir / "s1.runs").read_text() == "x\n"
    assert (run_dir / "s2.runs").read_text() == "x\nx\n"

    report = json.loads(out.read_text())
    assert report["complete"] and report["steps_dnf"] == 0
    assert report["steps"]["s2"]["v"] == 2
    assert report["metrics"]["alpha_per_sec"] == 10.0
    assert report["metrics"]["campaign_complete"] == 1.0

    clean_dir = tmp_path / "clean"
    clean_dir.mkdir()
    plan2 = _plan(clean_dir, sleep_s=2.0)
    state2, out2 = clean_dir / "state.jsonl", clean_dir / "report.json"
    p = _invoke(plan2, state2, out2)
    stdout, _ = p.communicate(timeout=120)
    assert p.returncode == 0, stdout
    uninterrupted = json.loads(out2.read_text())
    a, b = _strip_volatile(report), _strip_volatile(uninterrupted)
    for doc in (a, b):
        doc.pop("campaign", None)
        for s in doc["steps"].values():
            s.pop("_rc", None)
    assert a["steps"] == b["steps"]
    assert a["metrics"] == b["metrics"]
    assert a["steps_done"] == b["steps_done"] == 3

    hb = (run_dir / "hb.prom").read_text()
    assert "campaign_steps_done" in hb
    assert "campaign_steps_total" in hb


def test_torn_tail_is_truncated_and_step_reruns(tmp_path):
    state = tmp_path / "state.jsonl"
    header = json.dumps({"campaign": "t", "plan_fp": "f" * 16,
                         "rehearse": True, "steps": ["s1", "s2"]})
    good = json.dumps({"step": "s1", "rc": 0, "result": {"v": 1}, "elapsed_s": 0.1})
    state.write_text(header + "\n" + good + "\n" + '{"step": "s2", "rc": 0, "result": {"tr')
    st = campaign.load_state(str(state))
    assert st["torn"] is True
    assert list(st["results"]) == ["s1"]
    again = campaign.load_state(str(state))
    assert again["torn"] is False
    assert list(again["results"]) == ["s1"]
    assert again["header"]["campaign"] == "t"


def test_corrupt_middle_line_refuses_resume(tmp_path):
    state = tmp_path / "state.jsonl"
    state.write_text(
        '{"campaign": "t", "plan_fp": "x"}\n'
        '{"step": "s1", "rc": 0, "result"\n'
        '{"step": "s2", "rc": 0, "result": {"v": 2}}\n'
    )
    with pytest.raises(campaign.StateMismatch):
        campaign.load_state(str(state))


def test_state_from_different_plan_is_refused(tmp_path):
    plan_dir = tmp_path / "a"
    plan_dir.mkdir()
    plan = _plan(plan_dir, sleep_s=0.0)
    state, out = plan_dir / "state.jsonl", plan_dir / "report.json"
    p = _invoke(plan, state, out)
    stdout, _ = p.communicate(timeout=120)
    assert p.returncode == 0, stdout

    other_dir = tmp_path / "b"
    other_dir.mkdir()
    other_plan = _plan(other_dir, sleep_s=0.0)
    p = _invoke(other_plan, state, out)
    stdout, _ = p.communicate(timeout=120)
    assert p.returncode != 0
    assert "different" in stdout and "plan" in stdout


def test_dependency_dnf_cascades(tmp_path):
    steps = [
        {"id": "boom", "argv": [sys.executable, "-c", "raise SystemExit(3)"], "timeout_s": 30},
        {"id": "after", "argv": [
            sys.executable, "-c", "import json; print(json.dumps({'v': 9}))",
        ], "needs": ["boom"], "timeout_s": 30},
    ]
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(steps))
    state, out = tmp_path / "state.jsonl", tmp_path / "report.json"
    p = _invoke(plan, state, out)
    stdout, _ = p.communicate(timeout=120)
    assert p.returncode == 1, stdout
    report = json.loads(out.read_text())
    assert report["steps"]["boom"]["dnf"]
    assert "rc=3" in report["steps"]["boom"]["reason"]
    assert report["steps"]["after"]["dnf"]
    assert "dependency" in report["steps"]["after"]["reason"]
    assert report["metrics"]["campaign_complete"] == 0.0
    assert "elapsed_s" in report["steps"]["boom"]
    assert "env" in report["steps"]["boom"]


def test_step_timeout_becomes_structured_dnf(tmp_path):
    steps = [{"id": "hang", "argv": [sys.executable, "-c", "import time; time.sleep(60)"],
              "timeout_s": 1.5}]
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(steps))
    state, out = tmp_path / "state.jsonl", tmp_path / "report.json"
    p = _invoke(plan, state, out)
    stdout, _ = p.communicate(timeout=120)
    assert p.returncode == 1
    report = json.loads(out.read_text())
    res = report["steps"]["hang"]
    assert res["dnf"] and "watchdog" in res["reason"]
    assert res["elapsed_s"] >= 1.0


def test_report_inherits_platform_from_step_envs(monkeypatch):
    monkeypatch.setattr(campaign, "env_fingerprint",
                        lambda: {"platform": "uninitialized", "host": "runnerhost"})
    steps = [campaign.Step("s1", ["true"]), campaign.Step("s2", ["true"])]
    c = campaign.Campaign("t", steps, state_path="/dev/null")
    results = {
        "s1": {"step": "s1", "rc": 0, "elapsed_s": 1.0,
               "result": {"v": 1, "env": {"platform": "gpu",
                                          "device_kind": "NVIDIA H100 80GB HBM3",
                                          "device_count": 1, "host": "h1"}}},
        "s2": {"step": "s2", "rc": 0, "elapsed_s": 1.0, "result": {"v": 2}},
    }
    report = c.report(results)
    assert report["env"]["platform"] == "gpu"
    assert report["env"]["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert report["env"]["device_count"] == 1
    assert report["env"]["host"] != "h1"


# -- the port's runner equals JAX's on the same steps ------------------------------


def _parity_steps(mod, tmp_path: Path):
    return [
        mod.Step("a", [sys.executable, "-c",
                       "import json; print('noise'); print(json.dumps({'x_per_sec': 2.5, "
                       "'phase_s': {'r1': 1.0}, 'b_sweep': {'4': 3.0, '8': {'dnf': True}}}))"],
                 timeout_s=60),
        mod.Step("b", [sys.executable, "-c", "raise SystemExit(2)"], timeout_s=60),
        mod.Step("c", [sys.executable, "-c", "print('{\"v\": 1}')"], needs=["b"], timeout_s=60),
        mod.Step("d", [sys.executable, "-c", "print('no json here')"], timeout_s=60),
        mod.Step("e", [sys.executable, "-c", "import json; print(json.dumps("
                       "{'idle_fraction_k2': 0.25, 'device_idle_fraction': 0.5, "
                       "'compile': {'compiles': 2}}))"], env={"FOO": "1"}, timeout_s=60),
    ]


def _strip_line(line: dict) -> dict:
    out = {k: v for k, v in line.items() if k not in ("elapsed_s", "t0_ns", "t1_ns")}
    if isinstance(out.get("result"), dict):
        out["result"] = {k: v for k, v in out["result"].items()
                         if k not in ("elapsed_s", "env")}
    return out


def test_plan_fingerprint_state_lines_and_report_equal_jax(tmp_path):
    got_steps, want_steps = _parity_steps(campaign, tmp_path), _parity_steps(jcampaign, tmp_path)
    assert campaign.plan_fingerprint(got_steps) == jcampaign.plan_fingerprint(want_steps)
    assert [s.plan_entry() for s in got_steps] == [s.plan_entry() for s in want_steps]
    runs = {}
    for tag, mod, steps in (("port", campaign, got_steps), ("jax", jcampaign, want_steps)):
        d = tmp_path / tag
        d.mkdir()
        c = mod.Campaign("parity", steps, state_path=str(d / "state.jsonl"),
                         heartbeat_path=str(d / "hb.prom"), log=lambda _m: None)
        runs[tag] = (c.run(), (d / "state.jsonl").read_text().splitlines(),
                     (d / "hb.prom").read_text().splitlines())
    (rep, lines, hb), (jrep, jlines, jhb) = runs["port"], runs["jax"]
    assert lines[0] == jlines[0]  # the header: name, fingerprint, rehearse, step ids
    assert [_strip_line(json.loads(x)) for x in lines[1:]] == \
        [_strip_line(json.loads(x)) for x in jlines[1:]]
    assert [x for x in hb if "elapsed_s" not in x] == [x for x in jhb if "elapsed_s" not in x]
    assert rep["metrics"] == jrep["metrics"] and rep["context"] == jrep["context"]
    assert _strip_volatile(rep) == _strip_volatile(jrep)
    assert rep["steps"]["b"]["dnf"] and rep["steps"]["c"]["dnf"] and rep["steps"]["d"]["dnf"]
    assert rep["metrics"]["b_sweep_4_sigs_per_sec"] == 3.0
    assert "scripts/torch_gpu_round.py" in rep["comment"]


def test_lift_and_last_json_line_equal_jax():
    docs = {
        "flagship": {"metric": "m", "value": 1.0, "secp256k1_2of3_gg18_sigs_per_sec": 9.5,
                     "gg18_ot_checks_s": 1.25, "phase_s": {"r1": 2.0},
                     "gg18_ot_mta_phase_s": {"no_spans": 1},
                     "b_sweep": {"1024": 9.5, "16384": {"dnf": True, "reason": "oom"}},
                     "compile": {"compiles": 1, "unpredicted": 0}, "flag": True},
        "pipe": {"idle_fraction_k1": 0.5, "idle_fraction_k4": 0.25, "batch": 4096},
        "warm": {"warmboot_first_sign_s": 3.5, "warmboot_cache_hits": 1},
        "dead": {"dnf": True, "x_per_sec": 1.0},
    }
    assert campaign.lift_metrics(docs) == jcampaign.lift_metrics(docs)
    assert campaign.lift_context(docs) == jcampaign.lift_context(docs)
    for text in ("", "a\n{\"b\": 1}\nc", "[1]\n{bad\n{\"ok\": 2}\n"):
        try:
            want = jcampaign.last_json_line(text)
        except ValueError:
            with pytest.raises(ValueError):
                campaign.last_json_line(text)
            continue
        assert campaign.last_json_line(text) == want


def test_the_runner_imports_no_torch():
    code = ("import sys; from mpcium_tpu_torch.perf import campaign; "
            "c = campaign.Campaign('t', [campaign.Step('s', ['true'])], state_path='/dev/null'); "
            "rep = c.report({}); assert 'torch' not in sys.modules, 'torch imported'; "
            "print(rep['env']['platform'])")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(_ROOT), capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "uninitialized"
    assert campaign.STATE_BASENAME == "GPU_CAMPAIGN_state.json" != jcampaign.STATE_BASENAME
    assert campaign.HEARTBEAT_BASENAME.startswith("gpu_")


# -- the round driver -----------------------------------------------------------------


def test_report_name_counts_the_ports_reports_only(tmp_path):
    mod = _round_module()
    assert mod.next_campaign_basename(str(tmp_path)) == "GPU_CAMPAIGN_r01.json"
    (tmp_path / "CAMPAIGN_r07.json").write_text("{}")
    (tmp_path / "GPU_CAMPAIGN_state.json").write_text("{}")
    assert mod.next_campaign_basename(str(tmp_path)) == "GPU_CAMPAIGN_r01.json"
    (tmp_path / "GPU_CAMPAIGN_r01.json").write_text("{}")
    assert mod.next_campaign_basename(str(tmp_path)) == "GPU_CAMPAIGN_r02.json"


def test_plans_drive_the_port_and_rehearse_on_the_cpu(tmp_path):
    mod = _round_module()
    live = mod.default_plan(False, str(tmp_path))
    rehearse = mod.default_plan(True, str(tmp_path))
    ids = ["flagship", "pipeline_ab", "ed25519", "ot_crossover", "warm_boot"]
    assert [s.id for s in live] == [s.id for s in rehearse] == ids
    assert live[0].argv[1:] == ["-m", "mpcium_tpu_torch.bench"]
    assert live[0].timeout_s <= 3600 and live[0].parse is mod._bench_parse
    sweep_s = float(live[0].env["MPCIUM_BENCH_SWEEP_TIMEOUT_S"])
    assert sweep_s < float(live[0].env["MPCIUM_BENCH_WATCHDOG_S"]) < live[0].timeout_s
    for step in rehearse:
        assert "--device" in step.argv and "cpu" in step.argv, step.id
        assert not any("tpu_round" in a or a.endswith("bench.py") for a in step.argv)
    for step in live:
        assert "cpu" not in step.argv, step.id
    with pytest.raises(ValueError):
        mod._bench_parse('{"no": "metric"}')
    assert mod._bench_parse('x\n{"metric": "m", "value": 1}\n')["value"] == 1


def test_live_round_refuses_without_a_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    r = subprocess.run([sys.executable, _DRIVER, "--state", str(tmp_path / "st.jsonl")],
                       cwd=str(_ROOT), capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and "no CUDA device" in r.stderr
    assert not (tmp_path / "st.jsonl").exists()
    r = subprocess.run([sys.executable, _DRIVER, "--ed25519", "--b", "2"], cwd=str(_ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "none is available" in r.stderr


def test_ed25519_step_mode_on_the_cpu():
    r = subprocess.run([sys.executable, _DRIVER, "--ed25519", "--b", "2", "--device", "cpu"],
                       cwd=str(_ROOT), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["ed25519_batch"] == 2 and doc["ed25519_2of3_sigs_per_sec"] > 0
    assert doc["env"]["platform"] == "cpu"
