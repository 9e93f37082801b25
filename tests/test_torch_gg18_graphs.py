"""The GG18 engine's graphed functions (engine/graphs.py), on the CPU.

The JAX package jits 26 functions of ``engine/gg18_batch.py``; the port
graphs 25 of them (``_blk_commit`` has no caller in JAX). Each one,
replayed through the stand-in capture backend of ``test_torch_graphs``
at B=2, equals the JAX package's jitted function byte for byte (exact:
no tolerance): the committed golden ``gg18_graphs_b2.json`` was written
by the JAX functions on the same seeded inputs
(``utils/gg18_graphs_golden.py``; the live JAX run, which also shows the
golden is current, is slow-tier). A second call of each makes no host
sync and no upload, which a capture forbids. The engine sign and the
batched signing party, run through the stand-in, equal the JAX goldens
they equal on the plain path. Rewrite the golden::

    JAX_PLATFORMS=cpu python tests/test_torch_gg18_graphs.py --write-golden
"""
import json
import os
import sys
from pathlib import Path

if __name__ == "__main__":  # as a script: the repo root on the path, JAX on the CPU
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest
import torch
import torch_golden_writer as gw
from test_torch_gg18_party import GOLDEN as PARTY_GOLDEN
from test_torch_gg18_party import _pre
from test_torch_gg18_slice import CASES, _assert_matches, _golden_case, _port_sign
from test_torch_graphs import StandIn, _Syncs
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)

from mpcium_tpu_torch.engine import gg18_batch as gb
from mpcium_tpu_torch.engine import graphs
from mpcium_tpu_torch.perf import compile_watch
from mpcium_tpu_torch.utils import gg18_graphs_golden as g18

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parents[1] / "mpcium_tpu_torch" / "data" / "goldens" / \
    "gg18_graphs_b2.json"
PKG = g18.port_pkg("cpu")
FNS = g18.port_fns()


@pytest.fixture(autouse=True)
def fresh_graphs():
    graphs.clear()
    compile_watch.reset()
    yield
    graphs.clear()
    compile_watch.reset()


def _gg18_counts() -> dict:
    return {k: v for k, v in graphs.counts().items() if k.startswith("gg18.")}


def test_every_jitted_function_but_the_uncalled_one_is_graphed():
    assert sorted(_gg18_counts()) == sorted(f"gg18.{n}" for n in g18.FUNCTIONS)
    assert len(g18.FUNCTIONS) == 25
    assert not hasattr(gb, "_blk_commit")
    for name in g18.FUNCTIONS:
        assert FNS[name].graphs.name == f"gg18.{name}"


def test_each_graphed_function_replayed_equals_the_jax_golden():
    """Every function at B=2 through a stand-in capture: the miss holds
    its first replay to the eager body (so the plain body equals it too),
    the hit replays again; both equal the JAX package's jitted outputs
    byte for byte."""
    want = json.loads(GOLDEN.read_text())["record"]
    assert sorted(want) == sorted(g18.FUNCTIONS)
    with graphs.use_backend(StandIn()):
        assert g18.record(FNS, PKG) == want  # misses: captured
        assert g18.record(FNS, PKG) == want  # hits: replayed
    for name, c in _gg18_counts().items():
        assert c == {"captures": 1, "replays": 1}, name
    assert len(compile_watch.entries()) == len(g18.FUNCTIONS)


def test_second_calls_make_no_host_sync_and_no_upload(monkeypatch):
    """What a capture forbids: a scalar read back and a tensor built from
    host data, on the second call of each function (the first fills the
    per-device constant caches: the hash tags, q and q/2, p, x_j's bits)."""
    made = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def spy(data, *a, _real=real, **k):
            if not isinstance(data, torch.Tensor):
                made.append(type(data).__name__)
            return _real(data, *a, **k)

        monkeypatch.setattr(torch, name, spy)
    for name, args in g18.calls():
        args = g18.to_args(args, PKG)
        FNS[name](*args)
        made.clear()
        mode = _Syncs()
        with mode:
            FNS[name](*args)
        assert mode.bad == [] and made == [], name


def test_the_engine_sign_through_graphs_equals_the_jax_golden():
    """The Paillier engine's B=2 sign through a stand-in capture: the
    golden of the plain path (JAX's bytes), every block replayed for the
    second party after the first party's capture."""
    case = CASES[0]
    with graphs.use_backend(StandIn()):
        _assert_matches(_golden_case(*case[:2]), *_port_sign(*case))
    counts = _gg18_counts()
    for name in ("_blk_gamma", "_blk_gamma_check", "_blk_schnorr", "_blk_va", "_blk_pedersen",
                 "_blk_ut", "_blk_ut_check", "_withcheck_curve", "_mod_q_from_limbs"):
        assert counts[f"gg18.{name}"]["captures"] >= 1, name
        assert counts[f"gg18.{name}"]["replays"] >= 1, name
    for name in ("_blk_point_add", "_blk_point_eq", "_blk_R", "_blk_V", "_step_final",
                 "_int_mul_add", "_bits_pack", "_scalar_from_wide_bytes", "_base_mul_compressed"):
        assert counts[f"gg18.{name}"]["captures"] >= 1, name


def test_the_party_sign_through_graphs_equals_the_jax_golden():
    """Two batched signing parties (cohorts 1) through a stand-in capture:
    the wire and results of the JAX party's golden, byte for byte; the
    prover and verifier halves of the proofs and W_j from the VSS
    commitments run as graphed blocks of their own."""
    from mpcium_tpu_torch.protocol.ecdsa.batch_signing import (
        BatchedECDSASigningParty, quorum_material_digest,
    )
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import gg18_party_golden as pg

    want = json.loads(PARTY_GOLDEN.read_text())["record"]
    with graphs.use_backend(StandIn()):
        got = pg.party_record(gb, BatchedECDSASigningParty, run_protocol,
                              quorum_material_digest, _pre(), 1, device="cpu")
    assert got == want
    counts = _gg18_counts()
    for name in ("_blk_schnorr_prove", "_blk_schnorr_verify", "_blk_pedersen_prove",
                 "_blk_pedersen_verify", "_blk_va_check", "_blk_W_from_vss", "_blk_point_add",
                 "_blk_point_eq", "_step_final"):
        assert counts[f"gg18.{name}"]["captures"] >= 1, name


@pytest.mark.slow
def test_live_jax_functions_match_the_golden():
    gw.setup_jax()
    assert gw.jax_gg18_graphs_record() == json.loads(GOLDEN.read_text())["record"]


def write_golden() -> None:
    gw.setup_jax()
    GOLDEN.write_text(json.dumps({
        "about": "Outputs of the JAX package's jitted GG18 engine functions "
                 "(engine/gg18_batch.py) at B=2 on the CPU, points as affine x || y "
                 "(tests/test_torch_gg18_graphs.py --write-golden); inputs in "
                 "mpcium_tpu_torch/utils/gg18_graphs_golden.py",
        "B": g18.B, "seed": g18.SEED,
        "record": gw.jax_gg18_graphs_record(),
    }, indent=1) + "\n")
    print("gg18 graphs golden written", flush=True)


if __name__ == "__main__" and "--write-golden" in sys.argv:
    write_golden()
