"""The port's batched GG18 signing slice against the JAX engine.

Same keys, same digests and two instances of one seeded stream: the
PyTorch port (``device="cpu"``) must give byte-identical (r, s,
recovery, ok) to ``mpcium_tpu.engine.gg18_batch``. The JAX engine takes
many minutes on a CPU, so tier-1 compares against a committed golden
that the JAX engine wrote; the live comparison (which also checks that
the golden is current) is slow-tier.

Regenerate the golden with the JAX engine::

    JAX_PLATFORMS=cpu python tests/test_torch_gg18_slice.py --write-golden
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
GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "gg18_paillier_b2_1024.json"

UNIVERSE = ["node0", "node1", "node2"]
QUORUM = ["node0", "node1"]
THRESHOLD = 1
DOMAINS = {"alpha": 600, "beta_prime": 320, "gamma_bob": 600}
# (B, cohorts, keygen seed, sign seed, digest seed)
CASES = [(2, 1, 101, 102, 103), (4, 2, 201, 202, 203)]


def _digests(B: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, size=(B, 32), dtype=np.uint8
    )


def _jax_case(B: int, cohorts: int, kseed: int, sseed: int, dseed: int):
    """Run the JAX engine on one case → (public keys, outputs)."""
    from mpcium_tpu.cluster import load_test_preparams
    from mpcium_tpu.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    pre = load_test_preparams(bits=1024)
    shares = gb.dealer_keygen_secp_batch(
        B, UNIVERSE, THRESHOLD, rng=SeededStream(kseed)
    )
    signer = gb.GG18BatchCoSigners(
        QUORUM, [shares[UNIVERSE.index(p)] for p in QUORUM], pre,
        dom=gb.Domains(**DOMAINS), rng=SeededStream(sseed),
        mta_impl="paillier",
    )
    out = signer.sign(_digests(B, dseed), cohorts=cohorts)
    pubs = [s.public_key.hex() for s in shares[0]]
    return pubs, out


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


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

TEST_DOM = DOMAINS


def _golden_case(B: int, cohorts: int) -> dict:
    data = json.loads(GOLDEN.read_text())
    return next(c for c in data["cases"] if (c["B"], c["cohorts"]) == (B, cohorts))


def _port_sign(B: int, cohorts: int, kseed: int, sseed: int, dseed: int):
    """The port on the CPU → (shares, digests, outputs)."""
    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    shares = gb.dealer_keygen_secp_batch(B, UNIVERSE, THRESHOLD, rng=SeededStream(kseed))
    signer = gb.GG18BatchCoSigners(
        QUORUM, [shares[UNIVERSE.index(p)] for p in QUORUM],
        load_test_preparams(1024), dom=gb.Domains(**TEST_DOM),
        rng=SeededStream(sseed), device="cpu",
    )
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


def test_signatures_match_the_jax_golden_b2():
    case = CASES[0]
    _assert_matches(_golden_case(*case[:2]), *_port_sign(*case))


@pytest.mark.slow
def test_signatures_match_the_jax_golden_b4_two_cohorts():
    case = CASES[1]
    _assert_matches(_golden_case(*case[:2]), *_port_sign(*case))


@pytest.mark.slow
def test_live_port_matches_jax_engine_and_golden_is_current():
    case = CASES[0]
    pubs, out = _jax_case(*case)
    rec = _case_record(*case, pubs, out)
    assert rec == _golden_case(*case[:2])
    _assert_matches(rec, *_port_sign(*case))


def test_dealer_keygen_and_carried_keys_match_jax():
    from mpcium_tpu.cluster import load_test_preparams as jax_preparams
    from mpcium_tpu.engine import gg18_batch as jgb
    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    jpre = jax_preparams(1024)
    jshares = jgb.dealer_keygen_secp_batch(3, UNIVERSE, 1, rng=SeededStream(5),
                                           preparams=jpre)
    pre = gb.preparams_from_plain({k: v.to_json() for k, v in jpre.items()})
    assert pre == load_test_preparams(1024)
    shares = gb.dealer_keygen_secp_batch(3, UNIVERSE, 1, rng=SeededStream(5),
                                         preparams=pre)
    as_json = [[s.to_json() for s in row] for row in jshares]
    assert [[s.to_json() for s in row] for row in shares] == as_json
    assert gb.shares_from_plain(jshares) == shares
    assert gb.shares_from_plain(as_json) == shares


def test_tampered_alice_proof_is_attributed_to_its_session():
    """A corrupted proof inside a batch fails the combined (randomized)
    check, falls back to strict per-session verification and is blamed
    on exactly its session — as tests/test_gg18_batch.py shows for JAX."""
    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.core import bignum as bn
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    assert gb.BATCH_VERIFY == "rand"
    rng = SeededStream(31)
    pre = load_test_preparams(1024)
    ctx_a = gb.PartyCtx("node0", pre["node0"], rng, device="cpu")
    ctx_b = gb.PartyCtx("node1", pre["node1"], rng, device="cpu")
    mta = gb.MtaBatch(ctx_a, ctx_b, gb.Domains(**TEST_DOM))
    ks = [rng.randbelow(gb.Q) for _ in range(2)]
    kp = gb._scalar_to_plain(ctx_a.pmx, torch.as_tensor(bn.batch_to_limbs(ks, bn.P256)))
    u_bits = gb.rand_bit_tensor(2, gb.RAND_BITS, rng)
    c_a, _ = ctx_a.pmx.encrypt(kp, u_bits)
    Ra = mta.alice_randoms(2, rng)
    T = mta.alice_init(kp, Ra)
    e = mta.e_limbs(mta.alice_challenge(c_a, T))
    P = mta.alice_finish(e, kp, Ra, u_bits)
    assert mta.bob_check_alice(c_a, T, P, e, rng=rng).tolist() == [True, True]
    bad = dict(P)
    bad["s"] = P["s"].clone()
    bad["s"][1] = torch.as_tensor(
        bn.batch_to_limbs([rng.randbelow(ctx_a.N - 2) + 1], ctx_a.pmx.prof_n)[0]
    )
    assert mta.bob_check_alice(c_a, T, bad, e, rng=rng).tolist() == [True, False]


@pytest.mark.slow
def test_tampered_bob_proof_is_attributed_to_its_session():
    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.core import bignum as bn
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    rng = SeededStream(32)
    pre = load_test_preparams(1024)
    ctx_a = gb.PartyCtx("node0", pre["node0"], rng, device="cpu")
    ctx_b = gb.PartyCtx("node1", pre["node1"], rng, device="cpu")
    mta = gb.MtaBatch(ctx_a, ctx_b, gb.Domains(**TEST_DOM))
    ks = [rng.randbelow(gb.Q) for _ in range(2)]
    kp = gb._scalar_to_plain(ctx_a.pmx, torch.as_tensor(bn.batch_to_limbs(ks, bn.P256)))
    c_a, _ = ctx_a.pmx.encrypt(kp, gb.rand_bit_tensor(2, gb.RAND_BITS, rng))
    bs = [rng.randbelow(gb.Q) for _ in range(2)]
    b_e = torch.as_tensor(bn.batch_to_limbs(bs, mta.p_e))
    Rb = mta.bob_randoms(2, rng)
    Tb = mta.bob_respond(c_a, b_e, Rb)
    e_b = mta.e_limbs(mta.bob_challenge(c_a, Tb))
    Pb = mta.bob_finish(e_b, b_e, Rb)
    assert mta.alice_check_bob(c_a, Tb, Pb, e_b, rng=rng).tolist() == [True, True]
    bad = dict(Pb)
    bad["s"] = Pb["s"].clone()
    bad["s"][1] = torch.as_tensor(
        bn.batch_to_limbs([rng.randbelow(ctx_a.N - 2) + 1], ctx_a.pmx.prof_n)[0]
    )
    assert mta.alice_check_bob(c_a, Tb, bad, e_b, rng=rng).tolist() == [True, False]


def test_entry_points_need_an_explicit_cpu_device_without_a_gpu():
    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.utils.rng import SeededStream

    shares = gb.dealer_keygen_secp_batch(2, UNIVERSE, 1, rng=SeededStream(3))
    pair = [shares[0], shares[1]]
    pre = load_test_preparams(1024)
    with pytest.raises(ValueError, match="expected 'paillier' or 'ot'"):
        gb.GG18BatchCoSigners(QUORUM, pair, pre, mta_impl="dkls", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gb.GG18BatchCoSigners(QUORUM, pair, pre)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gb.GG18BatchCoSigners(QUORUM, pair, mta_impl="ot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gb.PartyCtx("node0", pre["node0"])


def write_golden() -> None:
    """Each case runs in a child process: one long XLA:CPU session that
    compiles both batch shapes can run out of JIT code mappings."""
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
        "about": "GG18 Paillier-MtA signatures written by "
                 "mpcium_tpu.engine.gg18_batch on the CPU "
                 "(tests/test_torch_gg18_slice.py --write-golden)",
        "fixture": "test_preparams_1024.json",
        "universe": UNIVERSE, "quorum": QUORUM, "threshold": THRESHOLD,
        "domains": DOMAINS, "cases": records,
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
