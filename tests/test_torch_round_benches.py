"""The round's two step benches against the JAX package's:
``scripts/torch_bench_ot_host.py`` (the host IKNP stage over the port's
native library; its digests equal ``scripts/bench_ot_host.py``'s stage on
the same bytes, across thread counts, and its native-against-torch
sub-stages agree) and ``scripts/torch_bench_pipeline.py`` (the cohort
A/B: signatures byte-identical across K, the artifact's keys those of
the committed JAX ``BENCH_pipeline_cpu.json``), at small sizes on the CPU."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_golden_writer import ot_host_down, pipe_host_down  # noqa: F401  (stop the host workers at module end)

ROOT = Path(__file__).resolve().parents[1]


def _script(name: str, alias: str):
    spec = importlib.util.spec_from_file_location(alias, ROOT / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ot_bench():
    return _script("torch_bench_ot_host.py", "torch_bench_ot_host")


def _stage_args(M: int):
    rng = np.random.default_rng(42)
    seeds3 = tuple(rng.integers(0, 256, size=(128, 32), dtype=np.uint8) for _ in range(3))
    delta = rng.integers(0, 2, size=128, dtype=np.uint8)
    delta_packed = np.packbits(delta, bitorder="little")
    return (seeds3, delta, delta_packed, np.nonzero(delta)[0],
            rng.integers(0, 256, size=M // 8, dtype=np.uint8), M, b"ab")


@pytest.mark.parametrize("threads", ["1", "3"])
def test_ot_host_stage_equals_the_jax_bench(ot_bench, threads, monkeypatch):
    jax_bench = _script("bench_ot_host.py", "jax_bench_ot_host")
    monkeypatch.setenv("MPCIUM_NATIVE_THREADS", threads)
    M = 4096
    got = ot_bench._stage(*_stage_args(M))
    want = jax_bench._stage(*_stage_args(M))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_ot_host_bench_cli_with_the_torch_crossover(ot_bench, capsys):
    assert ot_bench.main(["--m", "4096", "--runs", "1", "--threads", "2",
                          "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "ot_host_extension_stage_speedup" and rec["value"] > 0
    assert rec["m_ots"] == 4096 and rec["native"] is True
    for stage in ("prg", "transpose", "pads", "stage"):
        assert rec[f"ot_host_{stage}_s"] > 0 and rec[f"ot_device_{stage}_s"] > 0
    assert rec["device_platform"] == "cpu" and rec["env"]["platform"] == "cpu"
    assert "MPCIUM_NATIVE_THREADS" not in os.environ


def test_pipeline_ab_is_byte_identical_across_k(tmp_path, capsys):
    mod = _script("torch_bench_pipeline.py", "torch_bench_pipeline")
    out = tmp_path / "GPU_BENCH_pipeline_ab.json"
    rc = mod.main(["--device", "cpu", "--b", "4", "--k", "2", "--lenient", "--out", str(out)])
    assert rc == 0, capsys.readouterr()
    doc = json.loads(out.read_text())
    assert doc["signatures_bit_identical"] and doc["cohorts"] == [1, 2]
    assert doc["runs"]["1"]["sig_sha256"] == doc["runs"]["2"]["sig_sha256"]
    jax_doc = json.loads((ROOT / "BENCH_pipeline_cpu.json").read_text())
    assert set(jax_doc) <= set(doc)
    assert set(jax_doc["runs"]["1"]) <= set(doc["runs"]["1"])
    assert doc["env"]["platform"] == "cpu"
    assert mod.OUT_BASENAME.startswith("GPU_BENCH_")


def test_step_benches_raise_without_a_gpu(ot_bench):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    mod = _script("torch_bench_pipeline.py", "torch_bench_pipeline_nogpu")
    with pytest.raises(RuntimeError):
        mod.main(["--b", "2"])
    with pytest.raises(RuntimeError):
        ot_bench._device_ab(_stage_args(256)[0], 256, b"ab", 1, None)
    sys.modules.pop("torch_bench_pipeline_nogpu", None)
