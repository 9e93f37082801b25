"""The port's examples and operator tools: ``examples/torch/generate.py
--config`` against a running port deployment, the epoch migration
(``scripts/migration/torch_add_epoch.py``) against the JAX tool on an
identical store, and the three shell scripts with shims of the port's
CLIs (run in copies under ``tmp_path``, never in the repo)."""
from __future__ import annotations

import json
import os
import shutil
import stat
import subprocess
import sys
from pathlib import Path

import pytest

from torch_tcp import tcp_threads_down  # noqa: F401 — module fixture

from mpcium_tpu_torch.cli.deployment import Deployment
from mpcium_tpu_torch.store.kvstore import EncryptedFileKV, FileKV

ROOT = Path(__file__).resolve().parents[1]
SHELL = ["torch_deployment.sh", "torch_setup_identities.sh", "torch_setup_initiator.sh"]


# -- the example in networked mode ------------------------------------------


def test_generate_example_against_a_port_deployment(tmp_path, monkeypatch):
    """Broker + three ``--device cpu`` daemons; the example connects with
    ``--config`` (a networked deployment computes nothing in the client,
    so no ``--device``) and creates one wallet."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dep = Deployment(tmp_path / "dep", dev="cpu",
                     cfg={"batch_window_s": 1.0, "batch_manifest_timeout_s": 300.0,
                          "batch_deadline_ms": 900_000, "reply_timeout_s": 300.0})
    try:
        dep.start()
        r = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch" / "generate.py"),
             "--config", str(dep.staging / "config.yaml"), "wallet-example-net"],
            env=dep.env, cwd=dep.staging, capture_output=True, text=True, timeout=600)
    finally:
        stopped = dep.stop()
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "wallet created: wallet-example-net" in r.stdout
    keys = dict(ln.strip().split(" pubkey: ") for ln in r.stdout.splitlines() if "pubkey" in ln)
    assert len(bytes.fromhex(keys["ecdsa (secp256k1)"])) == 33
    assert len(bytes.fromhex(keys["eddsa (ed25519) "])) == 32
    assert all(code == 0 for code, _ in stopped.values()), stopped


# -- the epoch migration -----------------------------------------------------

SHARES = {"ecdsa:w1": {"wallet_id": "w1", "threshold": 1},
          "eddsa:w1": {"wallet_id": "w1", "threshold": 1},
          "eddsa:w2": {"wallet_id": "w2", "threshold": 2, "epoch": 3},
          "other:w1": {"note": "not a share"}}
KEYINFO = {"threshold_keyinfo/w1": {"participant_peer_ids": ["node0", "node1"], "threshold": 1},
           "threshold_keyinfo/w2": {"participant_peer_ids": ["node0"], "threshold": 2,
                                    "epoch": 1},
           "ready/node0": {"ok": True}}


def _store(root: Path):
    kv = EncryptedFileKV(root / "db", "pw")
    for k, v in SHARES.items():
        kv.put(k, json.dumps(v).encode())
    ckv = FileKV(root / "control")
    for k, v in KEYINFO.items():
        ckv.put(k, json.dumps(v).encode())


def _records(root: Path) -> dict:
    kv, ckv = EncryptedFileKV(root / "db", "pw"), FileKV(root / "control")
    return {**{k: json.loads(kv.get(k)) for k in kv.keys()},
            **{k: json.loads(ckv.get(k)) for k in ckv.keys()}}


def _migrate(script: Path, root: Path) -> str:
    r = subprocess.run([sys.executable, str(script), "--db", str(root / "db"),
                        "--control", str(root / "control"), "--password", "pw"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    return r.stdout.strip()


def test_migration_equals_the_jax_tool_and_is_idempotent(tmp_path):
    _store(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    port = ROOT / "scripts" / "migration" / "torch_add_epoch.py"
    jax = ROOT / "scripts" / "migration" / "add_epoch.py"
    assert _migrate(port, tmp_path / "port") == _migrate(jax, tmp_path / "jax") == \
        "backfilled epoch=0 on 3 records"
    recs = _records(tmp_path / "port")
    assert recs == _records(tmp_path / "jax")
    assert {k: v.get("epoch") for k, v in recs.items()} == {
        "ecdsa:w1": 0, "eddsa:w1": 0, "eddsa:w2": 3, "other:w1": None,
        "threshold_keyinfo/w1": 0, "threshold_keyinfo/w2": 1, "ready/node0": None}
    assert _migrate(port, tmp_path / "port") == "backfilled epoch=0 on 0 records"
    assert _records(tmp_path / "port") == recs


# -- the shell scripts -------------------------------------------------------


@pytest.mark.parametrize("name", SHELL)
def test_shell_script_parses_and_names_the_port_clis(name):
    path = ROOT / "scripts" / name
    assert subprocess.run(["bash", "-n", str(path)], capture_output=True).returncode == 0
    text = path.read_text()
    assert "mpcium-tpu-torch" in text
    assert "mpcium-tpu-cli" not in text and "mpcium-tpu start" not in text


def _shim(bin_dir: Path, name: str, body: str = "") -> Path:
    """A stand-in for a console script: records its arguments, one call a
    line, fields split by '|', then runs ``body``."""
    bin_dir.mkdir(parents=True, exist_ok=True)
    log = bin_dir / f"{name}.calls"
    path = bin_dir / name
    path.write_text("#!/usr/bin/env bash\n"
                    f"(IFS='|'; echo \"$*\") >> '{log}'\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return log


def _copy(tmp_path: Path, name: str) -> Path:
    """The script in a copy of the repo's layout: it cds to the copy's root."""
    dst = tmp_path / "repo" / "scripts" / name
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "scripts" / name, dst)
    return dst


@pytest.mark.parametrize("encrypt", [False, True], ids=["plain", "encrypt"])
def test_setup_identities_drives_the_port_cli(tmp_path, encrypt):
    script = _copy(tmp_path, "torch_setup_identities.sh")
    log = _shim(tmp_path / "bin", "mpcium-tpu-torch-cli",
                'if [ "$1" = generate-identity ]; then mkdir -p identity; '
                'touch "identity/$3_identity.json"; fi\n')
    env = dict(os.environ, PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    env.pop("ENCRYPT", None)
    if encrypt:
        env["ENCRYPT"] = "1"
    r = subprocess.run(["bash", str(script), "3"], env=env, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    flag = "|--encrypt" if encrypt else ""
    assert log.read_text().splitlines() == [
        "generate-peers|-n|3", "register-peers",
        *[f"generate-identity|--node|node{i}{flag}" for i in range(3)]]
    assert "identities ready: node0_identity.json" in r.stdout
    assert sorted(p.name for p in (tmp_path / "repo" / "identity").iterdir()) == [
        f"node{i}_identity.json" for i in range(3)]


def test_setup_initiator_patches_the_config(tmp_path):
    script = _copy(tmp_path, "torch_setup_initiator.sh")
    log = _shim(tmp_path / "bin", "mpcium-tpu-torch-cli",
                "echo '{\"public_key\": \"ab12\"}' > event_initiator.json\n")
    (tmp_path / "repo" / "config.yaml").write_text("event_initiator_pubkey: \"old\"\nx: 1\n")
    env = dict(os.environ, PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    env.pop("ENCRYPT", None)
    r = subprocess.run(["bash", str(script)], env=env, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    assert log.read_text().splitlines() == ["generate-initiator"]
    assert (tmp_path / "repo" / "config.yaml").read_text() == \
        "event_initiator_pubkey: \"ab12\"\nx: 1\n"


def test_deployment_script_needs_its_secrets_then_execs_the_port_daemon(tmp_path):
    log = _shim(tmp_path / "bin", "mpcium-tpu-torch", 'echo "env=$MPCIUM_ENVIRONMENT"\n')
    env = dict(os.environ, PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    for k in ("MPCIUM_BADGER_PASSWORD", "MPCIUM_BROKER_TOKEN", "MPCIUM_ENVIRONMENT"):
        env.pop(k, None)
    script = ROOT / "scripts" / "torch_deployment.sh"
    r = subprocess.run(["bash", str(script), "node0"], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode != 0 and "MPCIUM_BADGER_PASSWORD" in r.stderr and not log.exists()
    env.update(MPCIUM_BADGER_PASSWORD="pw", MPCIUM_BROKER_TOKEN="tok")
    r = subprocess.run(["bash", str(script), "node0"], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert log.read_text().splitlines() == ["start|-n|node0|--decrypt-private-key"]
    assert r.stdout.strip() == "env=production"
