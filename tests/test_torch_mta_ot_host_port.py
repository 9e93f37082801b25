"""The port's host pipelined OT extension against the port's own
references: the device route and the serial three-round composition at
chunk counts 1, 2 and 4, the extension counter, the eight wire
corruptions under ``MPCIUM_OT_DEVICE=0`` (the tamper path runs the wire
rounds, so the blame is the device route's), and a GG18 OT sign of B=2
through the host route against the JAX engine's golden
``mpcium_tpu_torch/data/goldens/gg18_ot_b2.json``. The JAX host route
itself: tests/test_torch_mta_ot_host.py.
"""
from __future__ import annotations

import pytest
import torch
from test_torch_gg18_ot_slice import CASES, _assert_matches, _golden_case, _port_sign
from test_torch_mta_ot import _port_leg, _port_limbs
from test_torch_mta_ot_host import B, KS, host_env, reconstructs, run  # noqa: F401  (host_env: a fixture)
from torch_golden_writer import ot_host_down, pipe_host_down  # noqa: F401  (stop the workers at module end)

torch.set_num_threads(1)  # tiny float64 matmuls: threads only contend


@pytest.fixture(scope="module")
def serial():
    """The serial three-round composition (the wire rounds)."""
    from mpcium_tpu_torch.utils import ot_golden as og
    from test_torch_mta_ot_host import _inputs

    a, bs = _inputs()
    rec = og.wire_record(_port_leg(), _port_limbs, a, bs)
    return {k: rec[k] for k in ("alpha", "beta", "verdicts")}


@pytest.mark.parametrize("K", KS)
def test_host_route_matches_the_device_route_and_the_serial_composition(
        K, host_env, serial, monkeypatch):
    got = run(_port_leg, _port_limbs, 2, K)[0][0]
    assert got == serial
    monkeypatch.setenv("MPCIUM_OT_DEVICE", "1")
    assert run(_port_leg, _port_limbs, 2, K)[0][0] == got


def test_the_counter_advances_and_each_extension_is_fresh(host_env):
    recs, leg = run(_port_leg, _port_limbs, 2, 2, runs=2)
    assert leg.ctr == 2
    assert recs[0]["alpha"] != recs[1]["alpha"] and recs[0]["beta"] != recs[1]["beta"]
    assert all(reconstructs(rec, 2) for rec in recs)


@pytest.mark.parametrize("case", range(8))
def test_tamper_blames_as_on_the_device_route(case, host_env):
    from mpcium_tpu_torch.utils import ot_golden as og

    _field, _set, party, check = og.TAMPER_CASES[case]
    lane, blames, _verdicts = og.tamper_run(_port_leg(), _port_limbs, B, case)
    want = [None] * B
    want[lane] = (party, check)
    assert blames == want


def test_gg18_ot_sign_on_the_host_route_matches_the_jax_golden_b2(host_env):
    case = CASES[0]
    shares, digests, out = _port_sign(*case)
    _assert_matches(_golden_case(*case[:2]), shares, digests, out)
