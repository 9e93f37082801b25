"""The port's claims gate (``scripts/torch_claimscheck.py``) against the
JAX package's ``scripts/claimscheck.py`` on the committed tree, its
``--regen --out`` renders, and its refusal to rewrite the root's
renders."""
from __future__ import annotations

import glob
import shutil
import subprocess
import sys
from pathlib import Path

from mpcium_tpu_torch.perf import ledger

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_claimscheck as cc  # noqa: E402

RENDERS = ("CLAIMS.json", "CLAIMS.md")


def _run(script: str, *args):
    return subprocess.run([sys.executable, str(ROOT / "scripts" / script), *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def _summary(stdout: str) -> str:
    return next(ln for ln in stdout.splitlines() if ln.startswith("claimscheck:"))


def test_check_mode_equals_the_jax_gate_on_the_committed_tree():
    port, jax = _run("torch_claimscheck.py"), _run("claimscheck.py")
    assert port.returncode == jax.returncode == 0, port.stdout + port.stderr
    assert _summary(port.stdout) == _summary(jax.stdout)
    assert _summary(port.stdout).endswith("— clean")


def test_regen_writes_the_committed_renders_under_out(tmp_path, capsys):
    before = {name: (ROOT / name).read_bytes() for name in RENDERS}
    assert cc.main(["--regen", "--out", str(tmp_path / "renders")]) == 0
    for name in RENDERS:
        assert (tmp_path / "renders" / name).read_bytes() == before[name], name
        assert (ROOT / name).read_bytes() == before[name]
    assert "claims: " in capsys.readouterr().out


def test_regen_without_out_is_refused():
    before = {name: (ROOT / name).stat().st_mtime_ns for name in RENDERS}
    r = _run("torch_claimscheck.py", "--regen")
    assert r.returncode == 2 and "--regen writes only under --out" in r.stderr
    assert {name: (ROOT / name).stat().st_mtime_ns for name in RENDERS} == before


def test_check_mode_fails_on_a_drifted_render(tmp_path, monkeypatch, capsys):
    for pattern in ledger.ARTIFACT_GLOBS:
        for path in glob.glob(str(ROOT / pattern)):
            shutil.copy(path, tmp_path)
    for name in RENDERS:
        shutil.copy(ROOT / name, tmp_path)
    monkeypatch.setattr(cc, "_ROOT", str(tmp_path))
    assert cc.main([]) == 0
    (tmp_path / "CLAIMS.md").write_text((ROOT / "CLAIMS.md").read_text() + "\nedited\n")
    assert cc.main([]) == 1
    out = capsys.readouterr().out
    assert "CLAIMS.md does not match the artifact corpus" in out
    assert "1 problem(s)" in out

