"""The port's host pipelined OT extension (``MPCIUM_OT_DEVICE=0``, or more
than ``MAX_PAYLOAD_SETS`` payload sets) against the JAX package's host
route.

The synthetic leg of tests/test_torch_mta_ot.py (base-OT keys from the
base OTs' postcondition) on the CPU at B=4, one deterministic stream: α,
β and the check verdicts at chunk counts 1, 2 and 4 must equal the JAX
host route's, and so must α and β of 11 payload sets (the host route by
count; the JAX side runs them without its checks, which draw nothing from
the stream, and the port's verdicts must be clean). The timings keys and
the extension span are the JAX host route's. The host route against the
port's device route, the serial composition, the tamper cases and the
GG18 engine: tests/test_torch_mta_ot_host_port.py.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_mta_ot import _jax_leg, _jax_limbs, _port_leg, _port_limbs
from torch_golden_writer import ot_host_down  # noqa: F401  (stops ot-host at module end)

from mpcium_tpu_torch.core.hostmath import SECP_N as Q

torch.set_num_threads(1)  # tiny float64 matmuls: threads only contend

B = 4
KS = (1, 2, 4)
SETS_BY_COUNT = 11  # one more than MAX_PAYLOAD_SETS: the host route whatever the setting


def _inputs(n_sets: int = 2):
    """a, and n_sets Bob scalar lists (γ, w, then more from the stream)."""
    from mpcium_tpu_torch.utils import ot_golden as og
    from mpcium_tpu_torch.utils.rng import DetRng

    a, g, w = og.leg_inputs(B)
    r = DetRng(99)
    more = [[r.randbelow(Q - 1) + 1 for _ in range(B)] for _ in range(n_sets - 2)]
    return a, [g, w] + more


def run(make_leg, limbs, n_sets: int, K: int, timings=None, runs: int = 1):
    """run_multi on a fresh leg → (records per run, leg); a record is
    α and β per set (hex) and the verdicts."""
    from mpcium_tpu_torch.utils import ot_golden as og

    a, bs = _inputs(n_sets)
    leg = make_leg()
    recs = []
    for _ in range(runs):
        out = leg.run_multi(limbs(a), tuple(limbs(b) for b in bs), chunks=K, timings=timings)
        recs.append({"alpha": [og.scalars_hex(al) for al, _be in out],
                     "beta": [og.scalars_hex(be) for _al, be in out],
                     "verdicts": og._verdicts(leg)})
    return recs, leg


def reconstructs(rec, n_sets: int) -> bool:
    """α_s + β_s ≡ a·b_s (mod q) on every lane of every set."""
    a, bs = _inputs(n_sets)
    return all(
        (int(rec["alpha"][s][i], 16) + int(rec["beta"][s][i], 16)) % Q == a[i] * b[i] % Q
        for s, b in enumerate(bs) for i in range(B)
    )


@pytest.fixture(scope="module")
def host_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPCIUM_OT_DEVICE", "0")
        yield


def _spans(mp, module: str):
    """Capture the (name, attrs) of every span ``module`` emits."""
    import importlib

    tracing = importlib.import_module(module)
    seen = []
    mp.setattr(tracing, "emit", lambda name, t0, t1, **kw: seen.append((name, kw)))
    return seen


@pytest.fixture(scope="module")
def jax_host(host_env):
    """The JAX host route: K = 1, 2, 4 at two sets (K=2 with its timings
    and span), and 11 sets at K=2 without checks."""
    recs = {}
    with pytest.MonkeyPatch.context() as mp:
        for K in KS:
            if K == 2:
                recs["timings"], recs["spans"] = {}, _spans(mp, "mpcium_tpu.utils.tracing")
            recs[K] = run(_jax_leg, _jax_limbs, 2, K, timings=recs.get("timings"))[0][0]
            mp.undo()
        mp.setenv("MPCIUM_OT_CHECKS", "0")
        recs[SETS_BY_COUNT] = run(_jax_leg, _jax_limbs, SETS_BY_COUNT, 2)[0][0]
    return recs


@pytest.mark.parametrize("K", KS)
def test_host_route_matches_the_jax_host_route(K, host_env, jax_host):
    got, leg = run(_port_leg, _port_limbs, 2, K)
    assert got[0] == jax_host[K]
    assert set(got[0]["verdicts"]) == {"kos", "gilboa", "consistency"}
    assert all(np.all(v) for v in leg.check_verdicts.values())
    assert reconstructs(got[0], 2)


def test_eleven_payload_sets_take_the_host_route_and_match_jax(jax_host, monkeypatch):
    monkeypatch.setenv("MPCIUM_OT_DEVICE", "1")  # the count alone picks the host route
    spans = _spans(monkeypatch, "mpcium_tpu_torch.utils.tracing")
    got, leg = run(_port_leg, _port_limbs, SETS_BY_COUNT, 2)
    want = jax_host[SETS_BY_COUNT]
    assert (got[0]["alpha"], got[0]["beta"]) == (want["alpha"], want["beta"])
    assert [n for n, _ in spans] == ["phase:ot_extension"] and "device" not in spans[0][1]
    assert spans[0][1]["sets"] == SETS_BY_COUNT
    assert reconstructs(got[0], SETS_BY_COUNT)
    assert leg.check_verdicts["gilboa"].shape == (SETS_BY_COUNT, B)
    assert leg.check_blame() == [None] * B


def test_timings_and_span_are_the_jax_host_routes(host_env, jax_host, monkeypatch):
    timings = {}
    spans = _spans(monkeypatch, "mpcium_tpu_torch.utils.tracing")
    run(_port_leg, _port_limbs, 2, 2, timings=timings)
    assert set(timings) == set(jax_host["timings"]) == {
        "host_s", "host_wait_s", "device_wait_s", "checks_s", "total_s"}
    assert timings["host_s"] > 0 and timings["checks_s"] > 0
    assert timings["total_s"] >= timings["checks_s"]
    jax_spans = jax_host["spans"]
    assert [n for n, _ in spans] == [n for n, _ in jax_spans] == ["phase:ot_extension"]
    (_, got), (_, want) = spans[0], jax_spans[0]
    assert list(got) == list(want)
    keys = ("node", "tid", "chunks", "sets", "checks")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
