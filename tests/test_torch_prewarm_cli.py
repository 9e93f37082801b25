"""The port's prewarm CLI (``scripts/torch_prewarm.py``): its work-list
line for line against the JAX package's ``scripts/prewarm.py --list``,
its gap gate, and a small warm walk on the CPU."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpcium_tpu_torch.warm import manifest as wm
from mpcium_tpu_torch.warm import prewarm as pw

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_prewarm as tp  # noqa: E402

NO_TRAFFIC = ["--ledger", "/nonexistent/COMPILE_LEDGER.json",
              "--history", "/nonexistent/history.jsonl"]
# the port's --list in a fresh interpreter, which must not import torch
_PORT_LIST = ("import sys; sys.path.insert(0, 'scripts'); import torch_prewarm as tp; "
              "rc = tp.main(sys.argv[1:]); "
              "assert 'torch' not in sys.modules and 'numpy' not in sys.modules; "
              "sys.exit(rc)")


@pytest.mark.parametrize("knobs", [
    [],
    ["--schemes", "eddsa,ecdsa", "--max-b", "64"],
    ["--threshold", "2", "--buckets", "1,4,16"],
    ["--schemes", "dkg,reshare", "--max-b", "8"],
], ids=["default", "eddsa-ecdsa-64", "t2-buckets", "dkg-reshare-8"])
def test_list_equals_the_jax_cli_line_for_line(knobs):
    port = subprocess.run([sys.executable, "-c", _PORT_LIST, "--list", *knobs, *NO_TRAFFIC],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    jax = subprocess.run([sys.executable, str(ROOT / "scripts" / "prewarm.py"), "--list",
                          *knobs, *NO_TRAFFIC], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert port.returncode == jax.returncode == 0, port.stderr + jax.stderr
    assert port.stdout.splitlines() == jax.stdout.splitlines()
    assert port.stdout.splitlines()[-1].endswith(" entries")


def test_check_passes_without_torch():
    r = subprocess.run([sys.executable, "-c", _PORT_LIST, "--check"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("— 0 problem(s)")
    jax = subprocess.run([sys.executable, str(ROOT / "scripts" / "prewarm.py"), "--check"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.stdout.splitlines()[-1] == jax.stdout.splitlines()[-1]


def test_check_fails_on_a_gap(monkeypatch, capsys):
    monkeypatch.setattr(wm, "default_knobs", lambda threshold=None: wm.WarmKnobs(key_type=()))
    assert tp.main(["--check"]) == 1
    out = capsys.readouterr().out
    assert "WARM GAP:" in out and "'key_type'" in out and "— 4 problem(s)" in out


def test_walk_on_the_cpu_warms_and_writes_the_report(tmp_path, monkeypatch, capsys):
    from mpcium_tpu_torch.ops import mulmod as K

    monkeypatch.setattr(pw, "_RAN", set())
    monkeypatch.setattr(K, "plain_calls", 19)  # an earlier caller's count is not the walk's
    assert tp.main(["--device", "cpu", "--schemes", "eddsa", "--max-b", "2",
                    "--out", str(tmp_path)]) == 0
    report = json.loads((tmp_path / wm.REPORT_BASENAME).read_text())
    assert report["totals"]["warmed"] == 2 and report["totals"]["failed"] == 0
    assert [(r["shape"], r["status"], r["device"]) for r in report["results"]] == [
        ("B1|q2", "warmed", "cpu"), ("B2|q2", "warmed", "cpu")]
    out = capsys.readouterr().out.splitlines()
    assert json.loads("\n".join(out[:out.index("}") + 1]))["warmed"] == 2
    k0 = json.loads(out[out.index("}") + 1])["k0"]  # EdDSA buckets never reach K0
    assert k0["launches"] == 0 and k0["plain_calls"] == 0
    assert out[-1] == f"report: {tmp_path / wm.REPORT_BASENAME}"


def test_walk_without_a_gpu_raises_before_any_entry(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        tp.main(["--schemes", "eddsa", "--max-b", "2", "--out", str(tmp_path)])
    assert not (tmp_path / wm.REPORT_BASENAME).exists()
