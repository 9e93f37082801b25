"""What the port's golden writers share (``python tests/test_torch_*.py
--write-golden``): each JAX case runs in a child process, and a long
JAX protocol run sheds its compiled executables before XLA:CPU runs out
of memory maps."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

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
