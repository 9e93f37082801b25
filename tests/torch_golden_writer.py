"""What the port's tests share: the golden writers (``python
tests/test_torch_*.py --write-golden``) run each JAX case in a child
process, and a long JAX protocol run sheds its compiled executables
before XLA:CPU runs out of memory maps; a module that runs a cohorted
pipeline stops the pipeline's host worker when it ends."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def child_record(script: str, *case) -> dict:
    """Run ``script --golden-case *case`` in a child process and return
    the JSON record it prints last. A child that fails (an XLA:CPU crash
    on some hosts) is retried once."""
    for attempt in range(2):
        r = subprocess.run([sys.executable, script, "--golden-case", *map(str, case)],
                           capture_output=True, text=True)
        if r.returncode == 0:
            break
        print(f"case {case} attempt {attempt}: rc={r.returncode}\n{r.stderr[-2000:]}",
              flush=True)
    r.check_returncode()
    return json.loads(r.stdout.strip().splitlines()[-1])


def setup_jax():
    """JAX on the CPU with the test compile cache; every compile is kept,
    so executables dropped by :func:`jit_relief` reload from disk."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", str(ROOT / ".jax_cache_tests"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return jax


def jit_relief(limit: int = 30000) -> None:
    """XLA:CPU maps JIT code per compiled executable, and a process may
    hold 65,530 memory maps: a long JAX protocol run drops its compiled
    executables once past ``limit`` maps (they reload from the cache)."""
    import gc

    import jax

    with open("/proc/self/maps") as f:
        if sum(1 for _ in f) > limit:
            jax.clear_caches()
            gc.collect()


def _jax_pool():
    mod = sys.modules.get("mpcium_tpu.engine.pipeline")
    return None if mod is None else mod._HOST_POOL


@pytest.fixture(scope="module", autouse=True)
def pipe_host_down():
    """Stop the ``pipe-host`` worker that a cohorted run (cohorts=2)
    starts, when the module that started it ends: the worker is not a
    daemon and lives as long as the process otherwise, and a later test
    in the same worker process that checks for leaked threads then
    fails. The JAX package's worker is stopped too when this module
    started it. A test module uses the fixture by importing it."""
    from mpcium_tpu_torch.engine import pipeline

    jax_before = _jax_pool()
    yield
    mods = [pipeline]
    if _jax_pool() is not None and _jax_pool() is not jax_before:
        mods.append(sys.modules["mpcium_tpu.engine.pipeline"])
    for mod in mods:
        with mod._POOL_LOCK:
            pool, mod._HOST_POOL = mod._HOST_POOL, None
        if pool is not None:
            pool.shutdown(wait=True)
