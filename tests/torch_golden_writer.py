"""What the port's tests share: the golden writers (``python
tests/test_torch_*.py --write-golden``) run each JAX case in a child
process, and a long JAX protocol run sheds its compiled executables
before XLA:CPU runs out of memory maps; a module that runs a cohorted
pipeline or the host OT route stops the host worker when it ends."""
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


def _stop_host_pool(mod, lock) -> None:
    with lock:
        pool, mod._HOST_POOL = mod._HOST_POOL, None
    if pool is not None:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module", autouse=True)
def ot_host_down():
    """Stop the ``ot-host`` workers that the host OT route starts (the
    port's, and the JAX package's when JAX's host route ran), when the
    module ends, for the reason :func:`pipe_host_down` gives. Each pool
    is made again at its next use. A test module uses the fixture by
    importing it."""
    yield
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot

    _stop_host_pool(mta_ot, mta_ot._POOL_LOCK)
    jax_mod = sys.modules.get("mpcium_tpu.protocol.ecdsa.mta_ot")
    if jax_mod is not None:
        _stop_host_pool(jax_mod, jax_mod._HOST_POOL_LOCK)


# ---------------------------------------------------------------------------
# the sharded signing step: the JAX package's records on its virtual mesh
# ---------------------------------------------------------------------------

VIRTUAL_DEVICES = 8  # the mesh tests/conftest.py gives the JAX package


def virtual_devices_env() -> None:
    """Ask XLA:CPU for VIRTUAL_DEVICES devices; before JAX is imported."""
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={VIRTUAL_DEVICES}").strip()


def jax_gg18_curve_leg(signer, digests):
    """The GG18 leg of ``__graft_entry__.dryrun_multichip`` on a signer
    whose sessions ``sharded.shard_gg18_sessions`` put on its mesh: the
    dry run's blocks and ring algebra, with k, γ and the blinds drawn
    from ``signer.rng`` (seeded) instead of ``secrets``. → r, s as (B, 32)
    big-endian bytes and the ok mask."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpcium_tpu.core import bignum as bnn
    from mpcium_tpu.engine import gg18_batch as gb
    from mpcium_tpu.engine import sharded

    mesh = signer.w[0].sharding.mesh
    Bg, ring = signer.B, signer.ring
    s_sess = NamedSharding(mesh, P(None, sharded.SESSIONS))
    m = ring.reduce(bnn.bytes_to_limbs_le(
        jax.device_put(jnp.asarray(digests[:, ::-1].copy()),
                       NamedSharding(mesh, P(sharded.SESSIONS))), bnn.P256, 22))
    k_st = jax.device_put(signer._rand_scalars_q(), s_sess)
    gamma_st = jax.device_put(signer._rand_scalars_q(), s_sess)
    g_blind = jax.device_put(signer._blinds_q(), s_sess)
    Gamma, comp_l, commit_l = [], [], []
    for i in range(2):
        pt, comp, commit = gb._blk_gamma(gamma_st[i], g_blind[i], gb._idx_row(i, Bg))
        Gamma.append(pt)
        comp_l.append(comp)
        commit_l.append(commit)
    kg = ring.mulmod(ring.addmod(k_st[0], k_st[1]), ring.addmod(gamma_st[0], gamma_st[1]))
    kw = ring.mulmod(ring.addmod(k_st[0], k_st[1]), ring.addmod(signer.w[0], signer.w[1]))
    zero = ring.const(0, (Bg,))
    deltas = jnp.stack([kg, zero])
    sigmas = jnp.stack([kw, zero])
    okC = gb._blk_gamma_check(g_blind[0], comp_l[0], gb._idx_row(0, Bg), commit_l[0]) \
        & gb._blk_gamma_check(g_blind[1], comp_l[1], gb._idx_row(1, Bg), commit_l[1])
    okR, _R_pt, r, _rec = gb._blk_R(ring.addmod(deltas[0], deltas[1]),
                                    gb._blk_point_add(Gamma[0], Gamma[1]))
    s = ring.addmod(
        ring.addmod(ring.mulmod(m, k_st[0]), ring.mulmod(r, sigmas[0])),
        ring.addmod(ring.mulmod(m, k_st[1]), ring.mulmod(r, sigmas[1])),
    )
    half = jnp.broadcast_to(jnp.asarray(bnn.to_limbs(gb.Q // 2, bnn.P256)), s.shape)
    s = jnp.where((bnn.compare(s, half) > 0)[..., None], ring.negmod(s), s)
    return {"r": np.asarray(bnn.limbs_to_bytes_le(r, bnn.P256, 32))[:, ::-1].copy(),
            "s": np.asarray(bnn.limbs_to_bytes_le(s, bnn.P256, 32))[:, ::-1].copy(),
            "ok": np.asarray(okR & okC)}


def jax_sharded_record() -> dict:
    """The JAX package's ``engine/sharded`` on the inputs of
    ``mpcium_tpu_torch/utils/sharded_golden.py``: ``sharded_sign`` on
    the VIRTUAL_DEVICES mesh at committee 1 and 2, and the dry run's GG18
    leg on its default mesh. The process must hold VIRTUAL_DEVICES JAX
    devices (:func:`virtual_devices_env`, or tests/conftest.py)."""
    import jax

    from mpcium_tpu.engine import gg18_batch as gb
    from mpcium_tpu.engine import sharded
    from mpcium_tpu_torch.utils import sharded_golden as sg

    assert len(jax.devices()) == VIRTUAL_DEVICES, jax.devices()
    inp = sg.eddsa_inputs()
    rec = {"B": sg.B, "eddsa": {}, "mesh": {}}
    for c in sg.COMMITTEES:
        mesh = sharded.make_mesh(VIRTUAL_DEVICES, committee=c)
        sigs, ok = sharded.sharded_sign(mesh, inp["r64"], inp["lamx"], inp["A_comp"],
                                        inp["messages"])
        rec["eddsa"][str(c)] = sg.eddsa_record(sigs, ok)
        rec["mesh"][str(c)] = list(mesh.devices.shape)
    shares, digests = sg.gg18_wallets(gb)
    mesh = sharded.make_mesh(VIRTUAL_DEVICES)
    signer = gb.GG18BatchCoSigners.curve_only(sg.QUORUM, shares[:2], rng=sg.gg18_signer_rng())
    sharded.shard_gg18_sessions(signer, mesh)
    rec["gg18"] = sg.gg18_record(jax_gg18_curve_leg(signer, digests))
    rec["mesh"]["gg18"] = list(mesh.devices.shape)
    return rec
