"""The port's batched DKG and resharing engines (engine/dkg_batch.py)
against the JAX package's.

``BatchedDKG`` (2-of-3, both curves) and ``BatchedReshare`` (its first
two members to a 3-of-5 committee) at B=4 must equal the committed
golden ``dkg_b4.json`` that the JAX engines wrote, at cohorts 1 and 2;
the shares recombine to the public keys. Rewrite the golden with the
JAX package (~5 min on a CPU)::

    JAX_PLATFORMS=cpu python tests/test_torch_dkg_batch.py --write-golden
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import pytest
import torch
import torch_golden_writer as gw
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "dkg_b4.json"


def _golden() -> dict:
    return json.loads(GOLDEN.read_text())["record"]


def _recombine(rows, t: int, order: int) -> int:
    """Lagrange-combine t+1 share records at x = 0 (host ints)."""
    from mpcium_tpu_torch.core import hostmath as hm

    pts = [(r["self_x"], int(r["share"])) for r in rows[: t + 1]]
    xs = [x for x, _ in pts]
    return sum(hm.lagrange_coeff(xs, x, order) * y for x, y in pts) % order


@pytest.mark.parametrize("cohorts", [1, 2])
def test_engines_match_the_jax_golden(cohorts):
    from mpcium_tpu_torch.engine import dkg_batch as dk
    from mpcium_tpu_torch.utils import dkg_golden as dg

    assert dg.engine_record(dk, cohorts, device="cpu") == _golden()


@pytest.mark.parametrize("key_type", ["ed25519", "secp256k1"])
def test_golden_shares_recombine_to_the_public_keys(key_type):
    from mpcium_tpu_torch.core import hostmath as hm
    from mpcium_tpu_torch.utils import dkg_golden as dg

    rec = _golden()[key_type]
    order = hm.ED_L if key_type == "ed25519" else hm.SECP_N
    for w in range(dg.B):
        dkg_rows = [row[w] for row in rec["dkg"]]
        new_rows = [row[w] for row in rec["reshare"]]
        secret = _recombine(dkg_rows[::-1], dg.THRESHOLD, order)  # any t+1 of the three
        assert secret == _recombine(new_rows[2:], dg.ENGINE["t_new"], order)
        pub = (hm.ed_compress(hm.ed_mul(secret, hm.ED_B)) if key_type == "ed25519"
               else hm.secp_compress(hm.secp_mul(secret, hm.SECP_G)))
        assert {r["public_key"] for r in dkg_rows + new_rows} == {pub.hex()}
        assert {r["epoch"] for r in new_rows} == {1}
        assert all(r["vss_commitments"][0] == pub.hex() for r in dkg_rows + new_rows)


@pytest.mark.parametrize("key_type", ["ed25519", "secp256k1"])
def test_a_bad_subshare_fails_its_lane_only(key_type):
    from mpcium_tpu_torch.engine import dkg_batch as dk
    from mpcium_tpu_torch.utils.rng import SeededStream

    _, order = dk._curve(key_type)
    coeffs = torch.as_tensor(dk._rand_scalars((3, 2, 4), order, SeededStream(3)))
    blinds = torch.zeros((3, 4, 32), dtype=torch.uint8)
    pts, commits = dk._commit_phase(coeffs, blinds, key_type)
    assert commits.shape == (3, 4, 32)
    xs = (1, 2, 3)
    subs = dk._subshare_phase(coeffs, key_type, xs)
    assert dk._verify_phase_points(subs, pts, key_type, xs).tolist() == [True] * 4
    ring = dk._curve(key_type)[0].scalar_ring()
    bad = subs.clone()
    bad[2, 1, 3] = ring.addmod(subs[2, 1, 3], ring.one_like(subs[2, 1, 3]))
    assert dk._verify_phase_points(bad, pts, key_type, xs).tolist() == [True] * 3 + [False]


def test_engines_check_their_arguments():
    from mpcium_tpu_torch.engine import dkg_batch as dk

    with pytest.raises(ValueError, match="0 < t < n"):
        dk.BatchedDKG(["a", "b"], 2, "secp256k1", device="cpu")
    with pytest.raises(ValueError, match="secp384"):
        dk._curve("secp384")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dk.BatchedDKG(["a", "b"], 1, "ed25519")


@pytest.mark.slow
def test_live_jax_engines_match_the_golden():
    assert _jax_case(2) == _golden()


def write_golden() -> None:
    """Each cohort count runs in a child process; both counts must give
    the same record."""
    from mpcium_tpu_torch.utils import dkg_golden as dg

    records = [gw.child_record(__file__, k) for k in dg.COHORTS]
    assert all(rec == records[0] for rec in records), "shares depend on the cohort count"
    GOLDEN.write_text(json.dumps({
        "about": "shares of mpcium_tpu.engine.dkg_batch.BatchedDKG and BatchedReshare on "
                 f"the CPU, equal at cohorts {dg.COHORTS} "
                 "(tests/test_torch_dkg_batch.py --write-golden); parameters in "
                 "mpcium_tpu_torch/utils/dkg_golden.py",
        "cohorts": dg.COHORTS,
        "record": records[0],
    }, indent=1) + "\n")


def _jax_case(cohorts: int) -> dict:
    gw.setup_jax()
    from mpcium_tpu.engine import dkg_batch as jdkg
    from mpcium_tpu_torch.utils import dkg_golden as dg

    class Engines:
        """The JAX engines, each built after a JIT relief."""

        @staticmethod
        def BatchedDKG(*a, **kw):
            gw.jit_relief()
            return jdkg.BatchedDKG(*a, **kw)

        @staticmethod
        def BatchedReshare(*a, **kw):
            gw.jit_relief()
            return jdkg.BatchedReshare(*a, **kw)

    return dg.engine_record(Engines, cohorts)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--write-golden" in sys.argv:
        write_golden()
    elif "--golden-case" in sys.argv:
        print(json.dumps(_jax_case(int(sys.argv[sys.argv.index("--golden-case") + 1]))))
