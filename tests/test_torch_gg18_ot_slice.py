"""The port's GG18 signing with the OT-MtA backend against the JAX engine.

Same keys, same digests and two instances of one seeded stream: the
PyTorch port (``mta_impl="ot"``, ``device="cpu"``) must give
byte-identical (r, s, recovery, ok) to ``mpcium_tpu.engine.gg18_batch``
with ``mta_impl="ot"``. Tier-1 compares against a committed golden that
the JAX engine wrote; B=4 at two cohorts, the live JAX cross-run and the
identifiable abort of a cheating leg are slow-tier.

Regenerate the golden with the JAX engine::

    JAX_PLATFORMS=cpu python tests/test_torch_gg18_ot_slice.py --write-golden
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
GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "gg18_ot_b2.json"

UNIVERSE = ["node0", "node1", "node2"]
QUORUM = ["node0", "node1"]
THRESHOLD = 1
# (B, cohorts, keygen seed, sign seed, digest seed)
CASES = [(2, 1, 301, 302, 303), (4, 2, 401, 402, 403)]
# the cheater: leg (0, 1) (Alice node0, Bob node1) corrupts Bob's Gilboa
# opening of payload set 0 on lane 1
TAMPER = {"field": "D", "lane": 1, "set": 0, "byte": 3}


def _digests(B: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, size=(B, 32), dtype=np.uint8
    )


def _jax_signer(B: int, kseed: int, sseed: int):
    from mpcium_tpu.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    shares = gb.dealer_keygen_secp_batch(
        B, UNIVERSE, THRESHOLD, rng=SeededStream(kseed)
    )
    signer = gb.GG18BatchCoSigners(
        QUORUM, [shares[UNIVERSE.index(p)] for p in QUORUM], None,
        rng=SeededStream(sseed), mta_impl="ot",
    )
    return shares, signer


def _jax_case(B: int, cohorts: int, kseed: int, sseed: int, dseed: int):
    """Run the JAX engine on one case → (public keys, outputs)."""
    shares, signer = _jax_signer(B, kseed, sseed)
    out = signer.sign(_digests(B, dseed), cohorts=cohorts)
    return [s.public_key.hex() for s in shares[0]], out


def _case_record(B, cohorts, kseed, sseed, dseed, pubs, out) -> dict:
    return {
        "B": B, "cohorts": cohorts, "keygen_seed": kseed,
        "sign_seed": sseed, "digest_seed": dseed,
        "digests": [bytes(d).hex() for d in _digests(B, dseed)],
        "public_keys": pubs,
        "r": [bytes(x).hex() for x in np.asarray(out["r"])],
        "s": [bytes(x).hex() for x in np.asarray(out["s"])],
        "recovery": [int(v) for v in np.asarray(out["recovery"])],
        "ok": [bool(v) for v in np.asarray(out["ok"])],
    }


def _golden_case(B: int, cohorts: int) -> dict:
    data = json.loads(GOLDEN.read_text())
    return next(c for c in data["cases"] if (c["B"], c["cohorts"]) == (B, cohorts))


def _port_signer(B: int, kseed: int, sseed: int):
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    shares = gb.dealer_keygen_secp_batch(B, UNIVERSE, THRESHOLD, rng=SeededStream(kseed))
    signer = gb.GG18BatchCoSigners(
        QUORUM, [shares[UNIVERSE.index(p)] for p in QUORUM],
        rng=SeededStream(sseed), mta_impl="ot", device="cpu",
    )
    return shares, signer


def _port_sign(B: int, cohorts: int, kseed: int, sseed: int, dseed: int):
    """The port on the CPU → (shares, digests, outputs)."""
    shares, signer = _port_signer(B, kseed, sseed)
    digests = _digests(B, dseed)
    return shares, digests, signer.sign(digests, cohorts=cohorts)


def _assert_matches(rec: dict, shares, digests, out) -> None:
    from mpcium_tpu_torch.core import hostmath as hm

    assert [s.public_key.hex() for s in shares[0]] == rec["public_keys"]
    assert [bytes(d).hex() for d in digests] == rec["digests"]
    assert [bytes(x).hex() for x in out["r"]] == rec["r"]
    assert [bytes(x).hex() for x in out["s"]] == rec["s"]
    assert [int(v) for v in out["recovery"]] == rec["recovery"]
    assert [bool(v) for v in out["ok"]] == rec["ok"] == [True] * rec["B"]
    for i, s in enumerate(shares[0]):
        pub = hm.secp_decompress(s.public_key)
        r = int.from_bytes(out["r"][i].tobytes(), "big")
        sv = int.from_bytes(out["s"][i].tobytes(), "big")
        assert hm.ecdsa_verify(pub, int.from_bytes(digests[i].tobytes(), "big"), r, sv)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_ot_signatures_match_the_jax_golden_b2():
    case = CASES[0]
    shares, digests, out = _port_sign(*case)
    _assert_matches(_golden_case(*case[:2]), shares, digests, out)


def test_curve_only_signer_holds_curve_state_and_cannot_sign():
    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.core import secp256k1 as sp
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    shares = gb.dealer_keygen_secp_batch(2, UNIVERSE, THRESHOLD, rng=SeededStream(7))
    signer = gb.GG18BatchCoSigners.curve_only(
        QUORUM, [shares[0], shares[1]], device="cpu"
    )
    assert signer.mta_impl == "none"
    assert signer.ctx is None and signer.mta is None and signer.ot_legs is None
    # Σ W_i = Y: the quorum's additive shares reconstruct each wallet key
    W = sp.add(signer.W_pts[0], signer.W_pts[1])
    assert sp.to_host(W) == [hm.secp_decompress(s.public_key) for s in shares[0]]
    assert sp.equal(W, signer.Y).tolist() == [True, True]
    with pytest.raises(RuntimeError, match="curve_only"):
        signer.sign(_digests(2, 1))


@pytest.mark.slow
def test_ot_signatures_match_the_jax_golden_b4_two_cohorts():
    case = CASES[1]
    shares, digests, out = _port_sign(*case)
    _assert_matches(_golden_case(*case[:2]), shares, digests, out)


@pytest.mark.slow
def test_live_ot_port_matches_jax_engine_and_golden_is_current():
    case = CASES[0]
    pubs, out = _jax_case(*case)
    rec = _case_record(*case, pubs, out)
    assert rec == _golden_case(*case[:2])
    _assert_matches(rec, *_port_sign(*case))


@pytest.mark.slow
def test_cheating_leg_aborts_the_cohort_like_the_jax_engine():
    """One tampered wire field on one lane: both engines raise
    CohortAbort naming the same (lane, party, check), and the same port
    signer signs cleanly again once the deviation stops."""
    from mpcium_tpu.engine.abort import CohortAbort as JaxCohortAbort
    from mpcium_tpu_torch.engine.abort import CohortAbort

    B, cohorts, kseed, sseed, dseed = CASES[0]
    _shares, jsigner = _jax_signer(B, kseed, sseed)
    jsigner.ot_legs[(0, 1)].set_tamper(dict(TAMPER))
    with pytest.raises(JaxCohortAbort) as jexc:
        jsigner.sign(_digests(B, dseed), cohorts=cohorts)
    shares, signer = _port_signer(B, kseed, sseed)
    signer.ot_legs[(0, 1)].set_tamper(dict(TAMPER))
    with pytest.raises(CohortAbort) as exc:
        signer.sign(_digests(B, dseed), cohorts=cohorts)
    assert exc.value.culprits == jexc.value.culprits == [(1, "node1", "gilboa")]
    assert exc.value.lanes() == [1]
    signer.ot_legs[(0, 1)].set_tamper(None)
    out = signer.sign(_digests(B, dseed + 1), cohorts=cohorts)
    assert out["ok"].all()


def write_golden() -> None:
    """Each case runs in a child process (one XLA:CPU session per batch
    shape)."""
    import subprocess

    records = []
    for i in range(len(CASES)):
        out = subprocess.run(
            [sys.executable, __file__, "--golden-case", str(i)],
            check=True, capture_output=True, text=True,
        ).stdout
        records.append(json.loads(out.strip().splitlines()[-1]))
        print(f"case {CASES[i][:2]} ok={records[-1]['ok']}", flush=True)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps({
        "about": "GG18 OT-MtA signatures written by "
                 "mpcium_tpu.engine.gg18_batch (mta_impl='ot', checks on) "
                 "on the CPU (tests/test_torch_gg18_ot_slice.py --write-golden)",
        "universe": UNIVERSE, "quorum": QUORUM, "threshold": THRESHOLD,
        "cases": records,
    }, indent=1) + "\n")


def _setup_jax() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", str(ROOT / ".jax_cache_tests"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
    elif "--golden-case" in sys.argv:
        _setup_jax()
        case = CASES[int(sys.argv[sys.argv.index("--golden-case") + 1])]
        pubs, out = _jax_case(*case)
        print(json.dumps(_case_record(*case, pubs, out)))
