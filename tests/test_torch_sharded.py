"""The port's session axis over several devices (``engine/sharded.py``,
``eddsa_batch.to_dev`` / ``arm_session_sharding``) on CPU meshes:

- ``sharded_sign`` on the meshes ``["cpu"] * 2`` (committee 1) and
  ``["cpu"] * 4`` (committee 2) signs the bytes the JAX package's
  ``sharded_sign`` signed on its mesh of eight virtual devices (the
  committed golden ``sharded_b8.json``), and those of its own one-device
  mesh; the GG18 curve leg of the multi-device dry run
  (``shard_gg18_sessions`` + ``gg18_curve_leg``) likewise, every (r, s)
  verified on the host;
- ``to_dev`` places as the JAX one does (``tests/test_sharded_consumer.py``):
  a dividing axis splits, a non-dividing one stays on the party's device,
  ``axis=1`` splits sessions and not the committee; the engine and the
  batched party under an armed mesh give the JAX goldens' bytes;
- the mesh rules of ``make_mesh`` / ``arm_session_axis``, a sharded K0
  leg, and span syncs that cover every mesh device.

The live JAX run of the golden's cases is slow-marked, as the JAX
package's sharded tests are. Write the golden (JAX on eight virtual CPU
devices, in a child process; about four minutes):

    JAX_PLATFORMS=cpu python tests/test_torch_sharded.py --write-golden
"""
import json
import os
import sys
from pathlib import Path

if __name__ == "__main__":  # as a script: the repo root on the path, JAX on the CPU
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--golden-case" in sys.argv:
        from torch_golden_writer import virtual_devices_env

        virtual_devices_env()

import numpy as np
import pytest
import torch
from torch_golden_writer import child_record, pipe_host_down  # noqa: F401  (stops pipe-host)

from mpcium_tpu_torch.cluster import load_test_preparams
from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.engine import eddsa_batch as eb
from mpcium_tpu_torch.engine import gg18_batch as gb
from mpcium_tpu_torch.engine import sharded
from mpcium_tpu_torch.ops import mulmod as K
from mpcium_tpu_torch.ops.modmul import MXUBarrett
from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
from mpcium_tpu_torch.protocol.runner import run_protocol
from mpcium_tpu_torch.utils import eddsa_golden as eg
from mpcium_tpu_torch.utils import sharded_golden as sg
from mpcium_tpu_torch.utils import tracing
from mpcium_tpu_torch.utils.rng import SeededStream

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "mpcium_tpu_torch" / "data" / "goldens"
GOLDEN = GOLDENS / "sharded_b8.json"
MESHES = {1: ["cpu"] * 2, 2: ["cpu"] * 4}  # committee → the CPU mesh's devices


@pytest.fixture(autouse=True)
def disarmed():
    """No test leaves a mesh armed: the armed mesh is process-global."""
    eb.arm_session_sharding(None)
    yield
    eb.arm_session_sharding(None)


def _golden() -> dict:
    return json.loads(GOLDEN.read_text())["record"]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# the two-phase EdDSA step and the GG18 curve leg against the JAX golden
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("committee", sg.COMMITTEES)
def test_sharded_sign_equals_the_jax_golden_and_the_unsharded_step(committee):
    inp = sg.eddsa_inputs()
    mesh = sharded.make_mesh(MESHES[committee], committee=committee)
    assert mesh.shape == (committee, 2)
    sigs, ok = sharded.sharded_sign(mesh, inp["r64"], inp["lamx"], inp["A_comp"], inp["messages"])
    assert sg.eddsa_record(sigs, ok) == _golden()["eddsa"][str(committee)]
    assert ok.all()
    one = sharded.make_mesh(["cpu"], committee=1)
    s1, ok1 = sharded.sharded_sign(one, inp["r64"], inp["lamx"], inp["A_comp"], inp["messages"])
    assert np.array_equal(sigs, s1) and np.array_equal(ok, ok1)
    # and the engine's fused step on the same nonces and challenges
    c64 = eb.challenge_hashes_host(sigs[:, :32], inp["A_comp"], inp["messages"])
    fused, ok_R = eb.fused_sign_step(_t(inp["r64"]), _t(c64), _t(inp["lamx"]))
    assert np.array_equal(fused.numpy(), sigs) and ok_R.all()
    for w in range(sg.B):
        assert hm.ed25519_verify(inp["public_keys"][w], inp["messages"][w], sigs[w].tobytes())


@pytest.mark.parametrize("devices,committee", [(None, None), (MESHES[1], 1), (MESHES[2], 2)])
def test_gg18_curve_leg_equals_the_jax_golden(devices, committee):
    shares, digests = sg.gg18_wallets(gb)
    signer = gb.GG18BatchCoSigners.curve_only(sg.QUORUM, shares[:2], rng=sg.gg18_signer_rng(),
                                              device="cpu")
    if devices is not None:
        mesh = sharded.make_mesh(devices, committee=committee)
        shards = sharded.shard_gg18_sessions(signer, mesh)
        assert signer.session_shards is shards and len(shards) == mesh.shape[1]
    leg = sharded.gg18_curve_leg(signer, digests)
    assert sg.gg18_record(leg) == _golden()["gg18"]
    assert leg["ok"].all() and all(sg.ecdsa_verified(shares, digests, leg))


def test_shard_gg18_sessions_places_w_w_pts_and_y_by_session_block():
    shares, _ = sg.gg18_wallets(gb)
    signer = gb.GG18BatchCoSigners.curve_only(sg.QUORUM, shares[:2], device="cpu")
    mesh = sharded.make_mesh(MESHES[2], committee=2)  # sessions axis 2: the committee is unused
    shards = sharded.shard_gg18_sessions(signer, mesh)
    assert [(sh.device, sh.sl) for sh in shards] == [
        (torch.device("cpu"), slice(0, 4)), (torch.device("cpu"), slice(4, 8))]
    for sh in shards:
        assert all(torch.equal(w, full[sh.sl]) for w, full in zip(sh.w, signer.w))
        for pt, full in zip(sh.W_pts + (sh.Y,), signer.W_pts + [signer.Y]):
            assert all(torch.equal(a, b[sh.sl]) for a, b in zip(pt, full))
    with pytest.raises(ValueError, match="does not split"):
        sharded.shard_gg18_sessions(signer, sharded.make_mesh(["cpu"] * 3, committee=1))


def test_sharded_mulmod_is_one_k0_call_per_session_device():
    N = load_test_preparams(2048)["node0"].paillier.N
    ctx = MXUBarrett(N, device="cpu")
    rng = np.random.default_rng(31)
    xs = [int.from_bytes(rng.bytes(256), "big") % N for _ in range(4)] + [0, 1, N - 1, N - 2]
    ys = xs[::-1]
    a, b = bn.batch_to_limbs(xs, ctx.prof), bn.batch_to_limbs(ys, ctx.prof)
    mesh = sharded.make_mesh(MESHES[1], committee=1)
    K.reset_counters()
    got = sharded.sharded_mulmod(mesh, N, a, b)
    assert (K.launches, K.plain_calls) == (0, 2)
    assert bn.batch_from_limbs(got, ctx.prof) == [x * y % N for x, y in zip(xs, ys)]
    assert np.array_equal(got, ctx.mulmod(_t(a), _t(b)).numpy())


# ---------------------------------------------------------------------------
# placement and the mesh rules
# ---------------------------------------------------------------------------


def test_to_dev_places_as_the_jax_package_does():
    """tests/test_sharded_consumer.py:32-48 on a CPU mesh of two."""
    mesh = sharded.arm_session_axis(MESHES[1])
    assert mesh.shape == (1, 2) and eb._SESSION_MESH is mesh
    x = eb.to_dev(np.zeros((8, 64), np.uint8))
    assert [p.shape for p in x] == [(4, 64), (4, 64)]
    # a real engine function keeps the split, piece by piece
    assert [tuple(eb.nonce_commitments(p)[0].shape) for p in x] == [(4, 22), (4, 22)]
    # odd tails stay on the party's device instead of failing
    y = eb.to_dev(np.zeros((7, 64), np.uint8), device="cpu")
    assert len(y) == 1 and y[0].shape == (7, 64) and y[0].device.type == "cpu"
    # party-leading round tensors split their SESSION axis (axis=1)
    z = eb.to_dev(np.arange(2 * 8 * 32, dtype=np.uint8).reshape(2, 8, 32), axis=1)
    assert [p.shape for p in z] == [(2, 4, 32), (2, 4, 32)]
    assert np.array_equal(eb.gather_host(z, axis=1),
                          np.arange(2 * 8 * 32, dtype=np.uint8).reshape(2, 8, 32))
    # the split follows the mesh's device count, as JAX's test does
    sharded.arm_session_axis(["cpu"] * 4)
    assert len(eb.to_dev(np.zeros((8, 64), np.uint8))) == 4
    assert len(eb.to_dev(np.zeros((6, 64), np.uint8), device="cpu")) == 1
    eb.arm_session_sharding(None)
    w = eb.to_dev(np.zeros((8, 64), np.uint8), device="cpu")
    assert len(w) == 1 and w[0].shape == (8, 64)


def test_mesh_rules():
    assert sharded.make_mesh(["cpu"] * 4).shape == (2, 2)  # committee 2 divides 4
    assert sharded.make_mesh(["cpu"] * 3).shape == (1, 3)
    assert sharded.make_mesh(["cpu"] * 4, committee=1).shape == (1, 4)
    assert sharded.make_mesh(["cpu"] * 2).shape == (2, 1)
    two = sharded.make_mesh(["cpu"] * 2, committee=1)
    assert two.session_devices == (torch.device("cpu"),) * 2
    assert two.device_set == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="must divide"):
        sharded.make_mesh(["cpu"] * 4, committee=3)
    # one device: nothing to split, and whatever was armed is disarmed
    sharded.arm_session_axis(MESHES[1])
    assert sharded.arm_session_axis(["cpu"]) is None and eb._SESSION_MESH is None
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default devices exist here")
    with pytest.raises(ValueError, match="refusing to silently degrade"):
        sharded.make_mesh(["cuda:0", "cuda:0"])
    for fn in (sharded.make_mesh, sharded.arm_session_axis):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_span_syncs_cover_every_mesh_device(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(str(d)))
    cuda = (torch.device("cuda:0"), torch.device("cuda:1"))
    eb.arm_session_sharding(sharded.SessionMesh((cuda,)))
    tracing.enable()
    try:
        tracing.span_sync(torch.device("cuda:0"))
        assert synced == ["cuda:0", "cuda:1"]
        synced.clear()
        tracing.span_sync(torch.device("cpu"))
        assert synced == ["cuda:0", "cuda:1"]
    finally:
        tracing.disable()
    synced.clear()
    tracing.span_sync(torch.device("cuda:0"))  # tracing off: no sync
    pt = tracing.PhaseTimer(torch.device("cpu"), {})
    pt.mark("p")
    assert synced == ["cuda:0", "cuda:1"]
    eb.arm_session_sharding(None)
    synced.clear()
    pt.mark("q")
    assert synced == []


# ---------------------------------------------------------------------------
# the engine and the batched party under an armed mesh
# ---------------------------------------------------------------------------


def test_engine_under_an_armed_mesh_signs_the_jax_golden():
    sharded.arm_session_axis(MESHES[1])  # B=4: cohorts of 2 split into pieces of 1
    want = json.loads((GOLDENS / "eddsa_b4.json").read_text())["record"]
    assert eg.engine_record(eb, _t, device="cpu") == want


def test_party_under_an_armed_mesh_sends_and_signs_the_jax_golden():
    sharded.arm_session_axis(MESHES[1])
    want = json.loads((GOLDENS / "eddsa_party_b4.json").read_text())["record"]
    assert eg.party_record(eb, BatchedEDDSASigningParty, run_protocol, device="cpu") == want


def test_ragged_messages_under_an_armed_mesh_sign_the_unsharded_bytes():
    shares = eb.dealer_keygen_batch(4, eg.UNIVERSE, 1, rng=SeededStream(41))
    msgs = [b"", b"a", b"b" * 200, b"c" * 32]

    def sign():
        signer = eb.BatchedCoSigners(eg.QUORUM, shares[:2], rng=SeededStream(42), device="cpu")
        return signer.sign(msgs, cohorts=2)

    plain = sign()
    sharded.arm_session_axis(MESHES[1])
    split = sign()
    assert np.array_equal(plain[0], split[0]) and split[1].all()


@pytest.mark.slow
def test_live_jax_sharded_step_equals_the_golden_and_the_port():
    """The JAX package's sharded_sign and dry-run GG18 leg run live on
    tests/conftest.py's eight virtual devices."""
    from torch_golden_writer import jax_sharded_record

    rec = jax_sharded_record()
    assert rec == _golden()


def write_golden() -> None:
    record = child_record(__file__, "sharded")
    GOLDEN.write_text(json.dumps({
        "about": "The JAX package's engine/sharded on its mesh of eight virtual CPU devices "
                 "(tests/test_torch_sharded.py --write-golden): sharded_sign at committee 1 "
                 "and 2, and the GG18 leg of __graft_entry__.dryrun_multichip with seeded "
                 "draws; inputs in mpcium_tpu_torch/utils/sharded_golden.py",
        "record": record,
    }, indent=1) + "\n")
    print("sharded golden written", flush=True)


if __name__ == "__main__" and "--golden-case" in sys.argv:
    from torch_golden_writer import jax_sharded_record, setup_jax

    setup_jax()
    print(json.dumps(jax_sharded_record()), flush=True)
elif __name__ == "__main__" and "--write-golden" in sys.argv:
    write_golden()
