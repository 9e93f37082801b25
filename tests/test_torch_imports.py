"""The port stands alone: no module of ``mpcium_tpu_torch/``, not
``chip_smoke.py`` and not the port's scripts that run on the card
import JAX or the JAX package (``mpcium_tpu``), at the top of a file or
inside a function. The card's machine has no JAX, and the port keeps
its own copy of what it needs."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "mpcium_tpu"}
# every script and example of the port, by glob: a new one is guarded
# the moment it exists
SCRIPTS = sorted((ROOT / "scripts").glob("torch_*.py")) + sorted(
    (ROOT / "scripts" / "migration").glob("torch_*.py")) + sorted(
    (ROOT / "examples" / "torch").glob("*.py"))
SOURCES = sorted((ROOT / "mpcium_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + SCRIPTS


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
    # the port's scripts: those once listed by hand, the five the hand
    # list missed, and the tools, the migration and the examples
    listed = ["torch_chaos_drill.py", "torch_load_soak.py", "torch_chaos_soak_alone.py",
              "torch_boot_alone.py", "torch_sign_ab.py", "torch_k0_ab.py",
              "torch_profile_alone.py", "torch_check_all.py", "torch_mpcflow_budget.py",
              "torch_ot_host_alone.py", "torch_gpu_round.py", "torch_bench_ot_host.py",
              "torch_bench_pipeline.py", "torch_wheel_spread.py"]
    missed = ["torch_serving_alone.py", "torch_deployment_alone.py", "torch_eddsa_opcount.py",
              "torch_eddsa_profile.py", "torch_verify_ab.py"]
    tools = ["torch_verify_drive.py", "torch_trace_check.py", "torch_perfcheck.py",
             "torch_claimscheck.py", "torch_prewarm.py", "torch_tools_alone.py"]
    assert {f"scripts/{n}" for n in listed + missed + tools} <= names
    assert {"scripts/migration/torch_add_epoch.py", "examples/torch/_connect.py",
            "examples/torch/generate.py", "examples/torch/sign.py",
            "examples/torch/reshare.py"} <= names
    # each a port of the JAX package's file of the same name
    for n in tools[:-1]:
        assert (ROOT / "scripts" / n[len("torch_"):]).is_file()
    assert (ROOT / "scripts" / "migration" / "add_epoch.py").is_file()
    for n in ("_connect.py", "generate.py", "sign.py", "reshare.py"):
        assert (ROOT / "examples" / n).is_file()
    # the daemon's boot: the session axis over local devices and warm start
    boot = ["engine/sharded", "warm/manifest", "warm/prewarm"]
    assert {f"mpcium_tpu_torch/{m}.py" for m in boot} <= names
    assert all((ROOT / "mpcium_tpu" / f"{m}.py").is_file() for m in boot)
    # the measurement tooling
    perf = ["perf/profile", "perf/statcheck", "perf/microbench", "perf/ledger", "perf/report",
            "perf/claims", "utils/annotations"]
    assert {f"mpcium_tpu_torch/{m}.py" for m in perf} <= names
    assert all((ROOT / "mpcium_tpu" / f"{m}.py").is_file() for m in perf)
    # the static-analysis gate (the JAX package's analysis/ less MPL4xx and shape/)
    analysis = ["analysis/__init__", "analysis/core", "analysis/baseline", "analysis/cli",
                "analysis/taxonomy", "analysis/rules/__init__", "analysis/rules/secret_hygiene",
                "analysis/rules/hygiene", "analysis/rules/lock_discipline",
                "analysis/rules/determinism", "analysis/rules/wire_thread",
                "analysis/flow/__init__", "analysis/flow/symbols", "analysis/flow/callgraph",
                "analysis/flow/engine", "analysis/flow/taint", "analysis/flow/residency"]
    assert {f"mpcium_tpu_torch/{m}.py" for m in analysis} <= names
    assert all((ROOT / "mpcium_tpu" / f"{m}.py").is_file() for m in analysis)
    # the native host library: the JAX package's module of the same path,
    # built from the port's own copy of the C++ source
    assert {"mpcium_tpu_torch/native/__init__.py", "mpcium_tpu_torch/native/plain.py"} <= names
    assert (ROOT / "mpcium_tpu" / "native" / "__init__.py").is_file()
    assert (ROOT / "mpcium_tpu_torch" / "native" / "batch_hash.cpp").is_file()
    from mpcium_tpu_torch import native

    assert native.SRC == ROOT / "mpcium_tpu_torch" / "native" / "batch_hash.cpp"
    # the measurement round: the repo-root bench.py and the JAX campaign,
    # ported as a module of the package and three scripts
    assert {"mpcium_tpu_torch/bench.py", "mpcium_tpu_torch/perf/campaign.py"} <= names
    assert (ROOT / "bench.py").is_file() and (ROOT / "mpcium_tpu" / "perf" / "campaign.py").is_file()
    for jax_script in ("tpu_round.py", "bench_ot_host.py", "bench_pipeline_cpu.py"):
        assert (ROOT / "scripts" / jax_script).is_file()
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
