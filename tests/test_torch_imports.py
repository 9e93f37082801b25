"""The port stands alone: no module of ``mpcium_tpu_torch/``, not
``chip_smoke.py`` and not the port's soak and chaos scripts import JAX or
the JAX package (``mpcium_tpu``), at the top of a file or inside a
function. The card's machine has no JAX,
and the port keeps its own copy of what it needs."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "mpcium_tpu"}
SCRIPTS = ["torch_chaos_drill.py", "torch_load_soak.py", "torch_chaos_soak_alone.py",
           "torch_boot_alone.py"]
SOURCES = sorted((ROOT / "mpcium_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "scripts" / name for name in SCRIPTS]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from ((alias.name, node.lineno) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value), node.lineno


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [f"{path.relative_to(ROOT)}:{line}: {name}" for name, line in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_guard_sees_every_port_module_and_every_import_form(tmp_path):
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert "chip_smoke.py" in names
    assert {"mpcium_tpu_torch/protocol/resharing.py", "mpcium_tpu_torch/protocol/base.py",
            "mpcium_tpu_torch/ops/mulmod.py"} <= names
    # the serving slice: the JAX package's modules of the same paths
    serving = ["wire", "utils/annotations", "utils/log", "utils/metrics", "utils/tracing",
               "core/softcrypto", "identity/identity", "transport/api", "transport/loopback",
               "store/kvstore", "store/keyinfo", "store/session_wal", "registry/registry",
               "config", "node/session", "node/node", "consumers/signing_consumer",
               "consumers/event_consumer", "consumers/batch_scheduler", "client/client",
               "cluster", "analysis/taxonomy"]
    assert {f"mpcium_tpu_torch/{m}.py" for m in serving} <= names
    assert all((ROOT / "mpcium_tpu" / f"{m}.py").is_file() for m in serving)
    # the networked deployment: the JAX package's modules of the same paths
    deployment = ["transport/secure", "transport/tcp", "store/broker_kv", "trace/__init__",
                  "trace/schema", "trace/export", "trace/recorder", "perf/compile_watch",
                  "node/daemon", "cli/__init__", "cli/main", "cli/ops", "cli/commands"]
    assert {f"mpcium_tpu_torch/{m}.py" for m in deployment} <= names
    assert all((ROOT / "mpcium_tpu" / f"{m}.py").is_file() for m in deployment)
    # and the port's own launcher of a local deployment (no JAX counterpart)
    assert "mpcium_tpu_torch/cli/deployment.py" in names
    # soak and chaos: the JAX package's modules of the same paths, the
    # two CLIs and the chip script's runner of phases 26 and 27
    chaos = ["faults/__init__", "faults/plan", "faults/transport", "faults/chaos", "soak",
             "perf/envfp", "warm/prewarm"]
    assert {f"mpcium_tpu_torch/{m}.py" for m in chaos} <= names
    assert all((ROOT / "mpcium_tpu" / f"{m}.py").is_file() for m in chaos)
    assert {f"scripts/{n}" for n in SCRIPTS} <= names
    # the daemon's boot: the session axis over local devices and warm start
    boot = ["engine/sharded", "warm/manifest", "warm/prewarm"]
    assert {f"mpcium_tpu_torch/{m}.py" for m in boot} <= names
    assert all((ROOT / "mpcium_tpu" / f"{m}.py").is_file() for m in boot)
    sample = tmp_path / "sample.py"
    sample.write_text("import jax.numpy as jnp\n"
                      "def f():\n"
                      "    from mpcium_tpu.core import hostmath\n"
                      "    import importlib\n"
                      "    return importlib.import_module('jax')\n"
                      "from mpcium_tpu_torch.core import hostmath\n"
                      "from . import sibling\n")
    found = sorted((line, name) for name, line in _imports(sample))
    assert found == [(1, "jax.numpy"), (3, "mpcium_tpu.core"), (4, "importlib"), (5, "jax"),
                     (6, "mpcium_tpu_torch.core")]
    assert [name.split(".")[0] in FORBIDDEN for _line, name in found] == \
        [True, True, False, True, False]
