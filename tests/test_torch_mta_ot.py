"""The port's OT-MtA leg (mpcium_tpu_torch/protocol/ecdsa/mta_ot.py)
against the JAX package's, live and through a committed golden.

A synthetic leg (base-OT keys from the base OTs' postcondition, as
tests/test_tamper_checks.py builds it) on the CPU at B=4: the wire
messages of the three-round composition, the ``run_multi`` transcript
at chunk counts 1 and 2, both parties' shares and the check verdicts
must equal the JAX leg's byte for byte, and the committed golden
``mpcium_tpu_torch/data/goldens/ot_leg_b4.json`` (which chip_smoke.py
also holds the card to). The check kernels are compared live on the same
tensors, and the eight wire corruptions blame exactly as the JAX leg
does.

Regenerate the golden with the JAX leg::

    JAX_PLATFORMS=cpu python tests/test_torch_mta_ot.py --write-golden
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)
import torch

torch.set_num_threads(1)  # tiny float64 matmuls: threads only contend

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "ot_leg_b4.json"
B = 4


def _jax_leg():
    """The JAX leg from the synthetic base-OT keys (the construction of
    tests/test_tamper_checks.py)."""
    from mpcium_tpu.protocol.ecdsa import mta_ot as jmo
    from mpcium_tpu_torch.utils import ot_golden as og
    from mpcium_tpu_torch.utils.rng import DetRng

    tag, k0, k1, delta = og.synth_base_ot()
    leg = jmo.OTMtALeg.__new__(jmo.OTMtALeg)
    leg.tag = tag
    leg.rng = DetRng(og.SYNTH_SEED + 1000)
    leg.ctr = 0
    leg.k0, leg.k1, leg.delta = k0, k1, delta
    leg.keysD = np.where(delta[:, None].astype(bool), k1, k0)
    leg.delta_packed = jmo._pack(delta)
    leg._delta_rows = np.nonzero(delta)[0]
    return leg


def _port_leg():
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot
    from mpcium_tpu_torch.utils import ot_golden as og
    from mpcium_tpu_torch.utils.rng import DetRng

    tag, k0, k1, delta = og.synth_base_ot()
    return mta_ot.OTMtALeg.from_base_ot(
        tag, k0, k1, delta, rng=DetRng(og.SYNTH_SEED + 1000), device="cpu"
    )


def _jax_limbs(vals):
    import jax.numpy as jnp

    from mpcium_tpu.core import bignum as jbn

    return jnp.asarray(jbn.batch_to_limbs(vals, jbn.P256))


def _port_limbs(vals):
    from mpcium_tpu_torch.core import bignum as bn

    return torch.as_tensor(bn.batch_to_limbs(vals, bn.P256))


@pytest.fixture(scope="module")
def jax_record():
    from mpcium_tpu_torch.utils import ot_golden as og

    return og.leg_record(_jax_leg, _jax_limbs, B)


@pytest.fixture(scope="module")
def port_record():
    from mpcium_tpu_torch.utils import ot_golden as og

    return og.leg_record(_port_leg, _port_limbs, B)


@pytest.fixture(scope="module")
def inputs():
    from mpcium_tpu_torch.utils import ot_golden as og

    return og.leg_inputs(B)


# ---------------------------------------------------------------------------
# whole-leg records: wire rounds, run_multi at K = 1, 2, shares, verdicts
# ---------------------------------------------------------------------------


def test_wire_rounds_match_jax(jax_record, port_record):
    assert port_record["wire"] == jax_record["wire"]
    v = port_record["wire"]["verdicts"]
    assert set(v) == {"kos", "gilboa", "consistency"}
    assert all(np.all(x) for x in v.values())


@pytest.mark.parametrize("K", [1, 2])
def test_run_multi_transcript_and_shares_match_jax(K, jax_record, port_record):
    got = port_record["run_multi"][str(K)]
    assert got["chunks"] == K
    assert got == jax_record["run_multi"][str(K)]


def test_wire_composition_equals_fused_path(port_record):
    """run_multi's transcript concatenates to the three-round messages,
    its shares and verdicts are the rounds' (every chunk count)."""
    wire = port_record["wire"]
    for rec in port_record["run_multi"].values():
        assert rec["U"] == wire["U"]
        assert rec["y0"] == [s["y0"] for s in wire["sets"]]
        assert rec["y1"] == [s["y1"] for s in wire["sets"]]
        assert rec["alpha"] == wire["alpha"] and rec["beta"] == wire["beta"]
        assert rec["verdicts"] == wire["verdicts"]


def test_shares_sum_to_the_products(port_record, inputs):
    from mpcium_tpu_torch.protocol.ecdsa.mta_ot import Q

    a, g, w = inputs
    for rec in [port_record["wire"]] + list(port_record["run_multi"].values()):
        for s, b in enumerate((g, w)):
            for i in range(B):
                al, be = int(rec["alpha"][s][i], 16), int(rec["beta"][s][i], 16)
                assert (al + be) % Q == a[i] * b[i] % Q, (s, i)


def test_leg_matches_the_committed_jax_golden(port_record):
    assert port_record == json.loads(GOLDEN.read_text())["record"]


def test_committed_golden_is_current(jax_record):
    assert jax_record == json.loads(GOLDEN.read_text())["record"]


# ---------------------------------------------------------------------------
# check kernels, live on the same tensors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def extension(inputs):
    """One port extension's tensors (Alice's rows, Bob's rows, U, the
    choice bits, payload rows of set 0) for the kernel comparisons."""
    from mpcium_tpu_torch.ops import hash_suite as hs
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot

    a, g, _w = inputs
    leg = _port_leg()
    msg_a = leg.alice_round1(_port_limbs(a), 0)
    t0, r_bits, _B, tag = leg._alice_state
    msgs_b, _betas = leg.bob_round2_multi((_port_limbs(g),), msg_a, 0)
    st = leg._device_state()
    U = torch.as_tensor(msg_a["U"])
    Qm = leg._prg(slice(2, 3), tag, 0, B)[0] ^ (U & st["delta_mask"])
    return {
        "tag": tag, "rows_a": hs.ot_transpose_core(t0), "rows_b": hs.ot_transpose_core(Qm),
        "U": U, "r_bits": r_bits, "delta": leg.delta, "msg_a": msg_a,
        "y0": msgs_b[0]["y0"], "y1": msgs_b[0]["y1"],
        "kos": mta_ot._fs_prefixes(tag, b"kos"),
        "gilboa": mta_ot._fs_prefixes(tag, b"gilboa", 0),
    }


def test_kos_tags_and_verify_match_jax(extension):
    import jax.numpy as jnp

    from mpcium_tpu.protocol.ecdsa import mta_ot as jmo
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot

    e = extension
    jpref = jmo._fs_prefixes(e["tag"], b"kos")
    for p, jp in zip(e["kos"], jpref):
        assert p.numpy().tobytes() == np.asarray(jp).tobytes()
    xbar, tbar = mta_ot._k_kos_tags(e["rows_a"], e["r_bits"], e["U"], *e["kos"])
    jx, jt = jmo._k_kos_tags(
        jnp.asarray(e["rows_a"].numpy()), jnp.asarray(e["r_bits"].numpy()),
        jnp.asarray(e["U"].numpy()), *jpref,
    )
    assert np.array_equal(xbar.numpy(), np.asarray(jx))
    assert np.array_equal(tbar.numpy(), np.asarray(jt))
    assert np.array_equal(xbar.numpy(), e["msg_a"]["kos_xbar"])
    # a flipped tag bit on lane 2 fails that lane only, on both sides
    bad = tbar.clone()
    bad[2, 5, 1] ^= 4
    delta = torch.as_tensor(e["delta"].astype(np.int64))
    got = mta_ot._k_kos_verify(e["rows_b"], delta, e["U"], xbar, bad, *e["kos"])
    want = jmo._k_kos_verify(
        jnp.asarray(e["rows_b"].numpy()), jnp.asarray(e["delta"]),
        jnp.asarray(e["U"].numpy()), jx, jnp.asarray(bad.numpy()), *jpref,
    )
    assert got.tolist() == np.asarray(want).tolist() == [True, True, False, True]


def test_psi_weights_match_jax(extension):
    import jax
    import jax.numpy as jnp

    from mpcium_tpu.protocol.ecdsa import mta_ot as jmo
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot

    e = extension
    got = mta_ot._psi_weights(
        torch.as_tensor(e["y0"]), torch.as_tensor(e["y1"]), *e["gilboa"]
    )
    want = jax.jit(jmo._psi_weights)(
        jnp.asarray(e["y0"]), jnp.asarray(e["y1"]), *jmo._fs_prefixes(e["tag"], b"gilboa", 0)
    )
    assert got.shape == (B, 256, 22)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_point_encoding_rejects_bad_points_without_raising():
    """A substituted B_pt / Beta_pt must decode to ok=False with a
    valid-shape point (the lane is then blamed), never raise."""
    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.core import secp256k1 as sp
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot

    pts = [hm.secp_mul(k, hm.SECP_G) for k in (1, 2, 12345)]
    enc = mta_ot._pt_encode(sp.from_host(pts, "cpu"))
    for row, p in zip(enc.numpy(), pts):
        assert bytes(row) == b"\x04" + p.x.to_bytes(32, "big") + p.y.to_bytes(32, "big")
    bad = enc.clone()
    bad[0, 0] = 2                         # wrong tag
    bad[1, 64] ^= 1                       # off the curve
    bad[2, 1:33] = 0xFF                   # x ≥ p
    ident = mta_ot._pt_encode(sp.identity((1,), "cpu"))  # 04 ‖ 0^64
    pt, ok = mta_ot._pt_decode(torch.cat([enc, bad, ident]))
    assert ok.tolist() == [True] * 3 + [False] * 4
    assert pt.X.shape == (7, 22)
    assert sp.to_host(sp.SecpPointJ(*(c[:3] for c in pt))) == pts


# ---------------------------------------------------------------------------
# identifiable abort, checks off, loud contract errors, base OTs
# ---------------------------------------------------------------------------

def _tamper_cases():
    from mpcium_tpu_torch.utils.ot_golden import TAMPER_CASES

    return TAMPER_CASES


@pytest.mark.parametrize("case", range(8), ids=[c[0] for c in _tamper_cases()])
def test_cheater_blamed_like_the_jax_leg(case):
    """Each wire field an active cheater controls, corrupted on its own
    lane: the port names the owner and the check of the JAX table on that
    lane and no one elsewhere, with the JAX leg's verdicts bit for bit."""
    from mpcium_tpu_torch.utils import ot_golden as og

    _field, _set, party, check = og.TAMPER_CASES[case]
    lane, blames, verdicts = og.tamper_run(_port_leg(), _port_limbs, B, case)
    assert blames[lane] == (party, check)
    assert [bl for i, bl in enumerate(blames) if i != lane] == [None] * (B - 1)
    assert og.tamper_run(_jax_leg(), _jax_limbs, B, case) == (lane, blames, verdicts)


def test_checks_off_gives_no_verdicts_and_correct_shares(monkeypatch, inputs):
    from mpcium_tpu_torch.protocol.ecdsa.mta_ot import Q
    from mpcium_tpu_torch.utils import ot_golden as og

    monkeypatch.setenv("MPCIUM_OT_CHECKS", "0")
    a, g, _w = inputs
    leg = _port_leg()
    msg_a = leg.alice_round1(_port_limbs(a), 0)
    assert "kos_xbar" not in msg_a and "kos_tbar" not in msg_a
    msgs_b, betas = leg.bob_round2_multi((_port_limbs(g),), msg_a, 0)
    assert not {"D", "B_pt", "Beta_pt"} & set(msgs_b[0])
    (alpha,) = leg.alice_round3_multi(msgs_b)
    assert leg.check_blame() is None
    leg2 = _port_leg()
    (pair,) = leg2.run_multi(_port_limbs(a), (_port_limbs(g),))
    assert leg2.check_blame() is None
    for al, be in ((alpha, betas[0]), pair):
        for i, (x, y) in enumerate(zip(og.scalars_hex(al), og.scalars_hex(be))):
            assert (int(x, 16) + int(y, 16)) % Q == a[i] * g[i] % Q


def test_version_mismatch_and_unchecked_peer_fail_loudly(inputs):
    a, g, _w = inputs
    leg = _port_leg()
    msg_a = leg.alice_round1(_port_limbs(a), 0)
    with pytest.raises(ValueError, match="wire version mismatch"):
        leg.bob_round2_multi((_port_limbs(g),), dict(msg_a, v=2), 0)
    stripped = {k: v for k, v in msg_a.items() if k not in ("kos_xbar", "kos_tbar")}
    with pytest.raises(ValueError, match="no KOS tags"):
        leg.bob_round2_multi((_port_limbs(g),), stripped, 0)
    msgs_b, _ = leg.bob_round2_multi((_port_limbs(g),), msg_a, 0)
    with pytest.raises(ValueError, match="wire version mismatch"):
        leg.alice_round3_multi([dict(msgs_b[0], v=2)])
    with pytest.raises(ValueError, match="no Gilboa opening"):
        leg.alice_round3_multi([
            {k: v for k, v in msgs_b[0].items() if k not in ("D", "B_pt", "Beta_pt")}
        ])


def test_base_ot_keys_agree_only_on_the_choice_bit():
    """Chou–Orlandi on the port's ladders: Bob's key is k^{Δ_j}_j, never
    the other one, and the wire points and keys equal python-int
    Chou–Orlandi for the same draws."""
    import hashlib

    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot
    from mpcium_tpu_torch.utils.rng import SeededStream

    rng = SeededStream(77)
    y, S = mta_ot.base_ot_sender_init(rng)
    delta, keysD, msgs = mta_ot.base_ot_receive(S, rng, device="cpu")
    k0, k1 = mta_ot.base_ot_sender_keys(y, msgs, device="cpu")
    chosen = np.where(delta[:, None].astype(bool), k1, k0)
    other = np.where(delta[:, None].astype(bool), k0, k1)
    assert np.array_equal(keysD, chosen)
    assert not (keysD == other).all(axis=1).any()
    # the same draws in python ints (rows 0-3)
    ref = SeededStream(77)
    assert ref.randbelow(mta_ot.Q - 1) + 1 == y
    d = np.frombuffer(ref.token_bytes(mta_ot.KAPPA), np.uint8) & 1
    xs = [ref.randbelow(mta_ot.Q - 1) + 1 for _ in range(mta_ot.KAPPA)]
    Spt = hm.secp_mul(y, hm.SECP_G)
    for j in range(4):
        xG = hm.secp_mul(xs[j], hm.SECP_G)
        R = hm.secp_add(xG, Spt) if d[j] else xG
        assert msgs[j] == hm.secp_compress(R)
        want = hashlib.sha256(
            b"mpcium-ot-base|" + hm.secp_compress(hm.secp_mul(xs[j], Spt))
        ).digest()
        assert bytes(keysD[j]) == want


def write_golden() -> None:
    from mpcium_tpu_torch.utils import ot_golden as og

    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps({
        "about": "OT-MtA leg records (wire rounds, run_multi at chunks 1 and 2) "
                 "written by mpcium_tpu.protocol.ecdsa.mta_ot on the CPU "
                 "(tests/test_torch_mta_ot.py --write-golden); format: "
                 "mpcium_tpu_torch/utils/ot_golden.py",
        "record": og.leg_record(_jax_leg, _jax_limbs, B),
    }, indent=1) + "\n")


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        sys.path.insert(0, str(ROOT))
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_compilation_cache_dir", str(ROOT / ".jax_cache_tests"))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        write_golden()
