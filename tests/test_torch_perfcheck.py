"""The port's micro-bench gate (``scripts/torch_perfcheck.py``): its
mechanics on synthetic samples (``microbench.run_all`` and
``ALL_BENCHES`` replaced, so no verdict rests on a timing taken here),
the committed GPU baseline, and the port's history and dashboard against
their regeneration."""
from __future__ import annotations

import json
import random
import sys
from pathlib import Path

import pytest
import torch

from mpcium_tpu_torch.perf import ledger, microbench

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_perfcheck as pc  # noqa: E402

ROWS = sorted(microbench.ALL_BENCHES)


def _samples(seed: int, scale: float = 1.0, n: int = 30):
    r = random.Random(seed)
    return [scale * (1e-3 + r.uniform(0.0, 5e-5)) for _ in range(n)]


@pytest.fixture
def gate(tmp_path, monkeypatch):
    """A baseline under ``tmp_path`` and stubbed benches: ``slow`` maps a
    row to its scale in the first measurement, ``retry`` to its scale on
    the re-measurement (default 1.0)."""
    monkeypatch.setattr(pc, "BASELINE_FILE", tmp_path / "baseline.json")
    state = {"slow": {}, "retry": {}, "runs": 0, "retried": []}

    def run_all(samples, device=None):
        assert str(device) == "cpu"
        state["runs"] += 1
        return {name: _samples(i + 100, state["slow"].get(name, 1.0))
                for i, name in enumerate(ROWS)}

    def bench(name, i):
        def fn(samples, device=None):
            state["retried"].append((name, None if device is None else str(device)))
            return _samples(i + 200, state["retry"].get(name, 1.0))
        return fn

    monkeypatch.setattr(microbench, "run_all", run_all)
    monkeypatch.setattr(microbench, "ALL_BENCHES",
                        {name: bench(name, i) for i, name in enumerate(ROWS)})

    def write(fingerprint=None):
        doc = {"host": "h", "fingerprint": fingerprint or pc.device_key(torch.device("cpu")),
               "benches": {name: {"samples": _samples(i)} for i, name in enumerate(ROWS)}}
        pc.BASELINE_FILE.write_text(json.dumps(doc))

    state["write"] = write
    return state


def test_strict_host_fails_a_fourfold_slowdown(gate, capsys):
    gate["write"]()
    assert pc.main(["--device", "cpu", "--inject-slowdown", "4"]) == 1
    out = capsys.readouterr()
    assert "FAIL — 10 regression(s)" in out.err
    assert out.out.count("[confirmed on retry]") == len(ROWS)


def test_flag_not_reproduced_on_retry_passes_with_its_note(gate, capsys):
    gate["write"]()
    gate["slow"]["sha256_block"] = 4.0
    gate["slow"]["prg_expand_device"] = 4.0
    assert pc.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "re-measuring prg_expand_device, sha256_block once to confirm" in out
    assert out.count("[regression not reproduced on retry]") == 2
    assert "OK — no regressions" in out
    # the device row is re-measured on the gate's device, the host row without one
    assert sorted(gate["retried"]) == [("prg_expand_device", "cpu"), ("sha256_block", None)]


def test_flag_reproduced_on_retry_fails(gate, capsys):
    gate["write"]()
    gate["slow"]["wheel_latency"] = gate["retry"]["wheel_latency"] = 2.0
    assert pc.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert "wheel_latency: REGRESSION" in out.out and "[confirmed on retry]" in out.out
    assert "FAIL — 1 regression(s)" in out.err


def test_foreign_host_is_informational(gate, capsys):
    gate["write"]("gpu/0123456789ab/1xNVIDIA H100 80GB HBM3")
    assert pc.main(["--device", "cpu", "--inject-slowdown", "4"]) == 0
    out = capsys.readouterr().out
    assert "informational comparison only" in out
    assert "OK (foreign host — informational)" in out
    assert "REGRESSION" in out and gate["retried"] == []  # reported, no retry


def test_missing_baseline_fails(gate, capsys):
    assert pc.main(["--device", "cpu"]) == 1
    assert "run --update-baseline first" in capsys.readouterr().err
    assert gate["runs"] == 0


def test_update_baseline_writes_every_row_with_its_stamp(gate):
    assert pc.main(["--device", "cpu", "--update-baseline", "--samples", "30"]) == 0
    doc = json.loads(pc.BASELINE_FILE.read_text())
    assert set(doc["benches"]) == set(ROWS)
    assert doc["fingerprint"] == pc.device_key(torch.device("cpu"))
    assert doc["fingerprint"].startswith("cpu/") and doc["card"] is None
    assert pc.main(["--device", "cpu"]) == 0  # a baseline passes against itself


def test_without_a_gpu_the_gate_raises(gate):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    gate["write"]()
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        pc.main([])
    assert gate["runs"] == 0


def test_committed_baseline_has_every_row_and_a_gpu_fingerprint():
    doc = json.loads(pc.BASELINE_FILE.read_text())
    assert pc.BASELINE_FILE == ROOT / "mpcium_tpu_torch" / "data" / "perf_baseline_micro_gpu.json"
    assert set(doc["benches"]) == set(ROWS)
    assert doc["fingerprint"].startswith("gpu/") and "H100" in doc["fingerprint"]
    assert doc["fingerprint"].split("/")[1] == doc["host"]
    assert doc["card"] and "H100" in doc["card"]
    assert all(len(b["samples"]) == doc["samples_per_bench"] for b in doc["benches"].values())


def test_history_and_dashboard_equal_their_regeneration(tmp_path, monkeypatch):
    monkeypatch.setattr(pc, "HISTORY_PATH", tmp_path / ledger.GPU_HISTORY_FILE)
    monkeypatch.setattr(pc, "DASHBOARD_PATH", tmp_path / "GPU_PERFORMANCE_dashboard.md")
    assert pc.main(["--regen-history"]) == 0
    for name in (ledger.GPU_HISTORY_FILE, "GPU_PERFORMANCE_dashboard.md"):
        assert (tmp_path / name).read_text() == (ROOT / name).read_text(), name
    text = (ROOT / "GPU_PERFORMANCE_dashboard.md").read_text()
    assert "scripts/torch_perfcheck.py --regen-history" in text
    assert "## Micro-baselines (perfcheck gate)" in text
