"""The port's batched EdDSA engine (engine/eddsa_batch.py) against the JAX
package's, on the same numpy inputs, shares and seeded stream.

Each device function is held against its JAX counterpart live at B=2;
whole signs against committed goldens that the JAX engine wrote
(``eddsa_b4.json``: B=4 at cohorts 1 and 2 plus ``fused_sign_step``;
``eddsa_party_b4.json``: the batched party's wire and results, checked
in tests/test_torch_eddsa_party.py). The live JAX engine run, which also
shows the goldens are current, is slow-tier. Rewrite both goldens with
the JAX package::

    JAX_PLATFORMS=cpu python tests/test_torch_eddsa_batch.py --write-golden
"""
import hashlib
import json
import os
import sys
from pathlib import Path

if __name__ == "__main__":  # as a script: the repo root on the path, JAX on the CPU
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)
import torch

import jax
import jax.numpy as jnp

from mpcium_tpu.engine import eddsa_batch as jeb
from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.engine import eddsa_batch as eb
from mpcium_tpu_torch.protocol.base import party_xs
from mpcium_tpu_torch.utils import eddsa_golden as eg
from mpcium_tpu_torch.utils.rng import SeededStream

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "mpcium_tpu_torch" / "data" / "goldens"
ENGINE_GOLDEN = GOLDENS / "eddsa_b4.json"
PARTY_GOLDEN = GOLDENS / "eddsa_party_b4.json"
L = hm.ED_L
RNG = np.random.default_rng(2552)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _limbs(vals) -> np.ndarray:
    return bn.batch_to_limbs(vals, bn.P256)


def _signed_batch(n: int = 2):
    """n plain RFC 8032 signatures: (sigs, pubs, messages) as uint8 rows."""
    seeds = [bytes([7 + i]) * 32 for i in range(n)]
    msgs = [bytes([i]) * 32 for i in range(n)]
    sigs = np.stack([np.frombuffer(hm.ed25519_sign_plain(s, m), np.uint8)
                     for s, m in zip(seeds, msgs)])
    pubs = np.stack([np.frombuffer(hm.ed25519_public_from_seed(s), np.uint8) for s in seeds])
    return sigs, pubs, msgs


def _c64(sigs, pubs, msgs) -> np.ndarray:
    return np.stack([np.frombuffer(hashlib.sha512(
        s[:32].tobytes() + a.tobytes() + m).digest(), np.uint8)
        for s, a, m in zip(sigs, pubs, msgs)])


# ---------------------------------------------------------------------------
# device functions against JAX, B = 2
# ---------------------------------------------------------------------------


def test_nonce_commitments_match_jax_and_host():
    r64 = RNG.integers(0, 256, (2, 2, 64), dtype=np.uint8)
    r64[0, 0] = 0xFF  # 2^512 - 1
    r, R = eb.nonce_commitments(_t(r64))
    jr, jR = jeb.nonce_commitments(jnp.asarray(r64))
    assert np.array_equal(_np(r), np.asarray(jr))
    assert np.array_equal(_np(R), np.asarray(jR))
    for row_r, row_R, raw in zip(_np(r).reshape(4, 22), _np(R).reshape(4, 32),
                                 r64.reshape(4, 64)):
        k = int.from_bytes(raw.tobytes(), "little") % L
        assert bn.from_limbs(row_r, bn.P256) == k
        assert row_R.tobytes() == hm.ed_compress(hm.ed_mul(k, hm.ED_B))


def test_aggregate_nonce_matches_jax_with_a_garbage_row():
    ks = [[3, 5], [11, L - 1]]
    R_all = np.stack([[np.frombuffer(hm.ed_compress(hm.ed_mul(k, hm.ED_B)), np.uint8)
                       for k in row] for row in ks])
    R_all[1, 1] = 0xFF  # y = 2^255 - 1 ≥ p: invalid
    R_sum, ok = eb.aggregate_nonce(_t(R_all))
    jR, jok = jeb.aggregate_nonce(jnp.asarray(R_all))
    assert np.array_equal(_np(R_sum), np.asarray(jR))
    assert _np(ok).tolist() == np.asarray(jok).tolist() == [True, False]
    assert _np(R_sum)[0].tobytes() == hm.ed_compress(hm.ed_mul(3 + 11, hm.ED_B))


def test_partial_and_combine_signatures_match_jax():
    r = _limbs([int(v) for v in RNG.integers(0, 2**62, 3)] + [L - 1]).reshape(2, 2, 22)
    c64 = RNG.integers(0, 256, (2, 64), dtype=np.uint8)
    c64[1] = 0xFF
    lamx = _limbs([L - 1, 12345, 1 << 251, 7]).reshape(2, 2, 22)
    cq = np.broadcast_to(c64, (2, 2, 64))
    parts = eb.partial_signature(_t(r), _t(cq), _t(lamx))
    jparts = jeb.partial_signature(jnp.asarray(r), jnp.asarray(cq), jnp.asarray(lamx))
    assert np.array_equal(_np(parts), np.asarray(jparts))
    R = RNG.integers(0, 256, (2, 32), dtype=np.uint8)
    sigs, s = eb.combine_signatures(parts, _t(R))
    jsigs, js = jeb.combine_signatures(jparts, jnp.asarray(R))
    assert np.array_equal(_np(sigs), np.asarray(jsigs))
    assert np.array_equal(_np(s), np.asarray(js))
    for b in range(2):
        c = int.from_bytes(c64[b].tobytes(), "little") % L
        want = sum(bn.from_limbs(r[p, b], bn.P256)
                   + c * bn.from_limbs(lamx[p, b], bn.P256) for p in range(2)) % L
        assert int.from_bytes(_np(sigs)[b, 32:].tobytes(), "little") == want


def test_verify_signatures_matches_jax_on_good_and_bad_rows():
    sigs, pubs, msgs = _signed_batch(2)
    c64 = _c64(sigs, pubs, msgs)
    wrong = _c64(sigs, pubs, [b"evil" * 8] * 2)
    high = sigs.copy()  # s + l: the same group element, out of range
    for b in range(2):
        s = int.from_bytes(sigs[b, 32:].tobytes(), "little") + L
        high[b, 32:] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
    garbage = sigs.copy()
    garbage[1, :32] = 0xFF
    cases = [(sigs, c64, [True, True]), (sigs, wrong, [False, False]),
             (high, c64, [False, False]), (garbage, c64, [True, False])]
    for sg, c, want in cases:
        got = _np(eb.verify_signatures(_t(sg), _t(pubs), _t(c))).tolist()
        ref = np.asarray(jeb.verify_signatures(
            jnp.asarray(sg), jnp.asarray(pubs), jnp.asarray(c))).tolist()
        assert got == ref == want


def test_fused_step_equals_the_round_step_chain_and_jax():
    r64 = RNG.integers(0, 256, (2, 2, 64), dtype=np.uint8)
    c64 = RNG.integers(0, 256, (2, 64), dtype=np.uint8)
    lamx = _limbs([5, L - 2, 1 << 200, 99]).reshape(2, 2, 22)
    blinds = RNG.integers(0, 256, (2, 2, 32), dtype=np.uint8)
    sigs, ok_R = eb.fused_sign_step(_t(r64), _t(c64), _t(lamx))
    jsigs, jok = jeb.fused_sign_step(jnp.asarray(r64), jnp.asarray(c64), jnp.asarray(lamx))
    assert np.array_equal(_np(sigs), np.asarray(jsigs))
    assert _np(ok_R).tolist() == np.asarray(jok).tolist() == [True, True]
    pref = torch.as_tensor(np.frombuffer(eb.COMMIT_PREFIX, np.uint8).copy())
    st = eb.round_step_nonce({"r64": _t(r64), "blinds": _t(blinds)}, pref)
    assert st["commit_msg"].shape == (2, 2, 23 + 32 + 32)
    st = eb.round_step_aggregate(st)
    assert bool(st["fraud_free"])
    st = eb.round_step_partial(st, _t(c64), _t(lamx))
    assert np.array_equal(_np(st["sigs"]), _np(sigs))
    assert _np(st["ok_R"]).tolist() == [True, True]


def test_challenge_hashes_paths_agree():
    sigs, pubs, msgs = _signed_batch(2)
    want = _c64(sigs, pubs, msgs)
    R = sigs[:, :32]
    assert np.array_equal(eb.challenge_hashes(R, pubs, msgs, "cpu"), want)
    assert np.array_equal(_np(eb.challenge_device(_t(R), pubs, np.stack(
        [np.frombuffer(m, np.uint8) for m in msgs]))), want)
    ref = jeb.challenge_device(jnp.asarray(R), jnp.asarray(pubs), jnp.asarray(
        np.stack([np.frombuffer(m, np.uint8) for m in msgs])))
    assert np.array_equal(np.asarray(ref), want)
    ragged = [msgs[0], b"short"]
    assert eb.challenge_hashes(R, pubs, ragged)[1].tobytes() == hashlib.sha512(
        R[1].tobytes() + pubs[1].tobytes() + b"short").digest()


# ---------------------------------------------------------------------------
# keygen and whole signs
# ---------------------------------------------------------------------------


def test_dealer_keygen_matches_jax():
    got = eb.dealer_keygen_batch(3, eg.UNIVERSE, 1, rng=SeededStream(5))
    ref = jeb.dealer_keygen_batch(3, eg.UNIVERSE, 1, rng=SeededStream(5))
    assert [[s.to_json() for s in row] for row in got] == [
        [s.to_json() for s in row] for row in ref]
    for w in range(3):
        shares = {s[w].self_x: s[w].share for s in got}
        secret = hm.shamir_reconstruct({x: shares[x] for x in (1, 3)}, L)
        assert hm.ed_compress(hm.ed_mul(secret, hm.ED_B)) == got[0][w].public_key


def _golden(path: Path) -> dict:
    return json.loads(path.read_text())["record"]


def _signer(rng_seed: int = eg.ENGINE["sign"]):
    shares = eb.dealer_keygen_batch(eg.B, eg.UNIVERSE, eg.THRESHOLD,
                                    rng=SeededStream(eg.ENGINE["keygen"]))
    quorum = [shares[eg.UNIVERSE.index(p)] for p in eg.QUORUM]
    return shares, eb.BatchedCoSigners(eg.QUORUM, quorum, rng=SeededStream(rng_seed),
                                       device="cpu")


def _host_sign(shares, msgs, seed: int) -> np.ndarray:
    """The quorum's signatures in python ints, from the same stream draws
    (q × nonces, then q × blinds, as the engine draws them)."""
    rng = SeededStream(seed)
    B, q = len(msgs), len(eg.QUORUM)
    r64 = [rng.token_bytes(B * 64) for _ in range(q)]
    for _ in range(q):
        rng.token_bytes(B * 32)  # blinds
    xs = party_xs(eg.UNIVERSE)
    qx = [xs[p] for p in eg.QUORUM]
    out = []
    for w in range(B):
        rs = [int.from_bytes(r64[p][64 * w: 64 * (w + 1)], "little") % L for p in range(q)]
        Rb = hm.ed_compress(hm.ed_mul(sum(rs) % L, hm.ED_B))
        A = shares[0][w].public_key
        c = hm.sha512_int_le(Rb, A, msgs[w]) % L
        s = sum(rs[p] + c * hm.lagrange_coeff(qx, qx[p], L)
                * shares[eg.UNIVERSE.index(pid)][w].share for p, pid in enumerate(eg.QUORUM))
        out.append(Rb + (s % L).to_bytes(32, "little"))
    return np.stack([np.frombuffer(o, np.uint8) for o in out])


@pytest.mark.parametrize("cohorts", eg.ENGINE["cohorts"])
def test_sign_matches_the_jax_golden(cohorts):
    want = _golden(ENGINE_GOLDEN)
    shares, signer = _signer()
    msgs = eg.messages(eg.B, eg.ENGINE["messages"])
    assert [s.public_key.hex() for s in shares[0]] == want["public_keys"]
    assert [m.hex() for m in msgs] == want["messages"]
    sigs, ok = signer.sign(msgs, cohorts=cohorts)
    assert {"signatures": [bytes(r).hex() for r in sigs], "ok": ok.tolist()} == \
        want["cohorts"][str(cohorts)]
    assert ok.all()
    assert np.array_equal(sigs, _host_sign(shares, msgs, eg.ENGINE["sign"]))
    for w in range(eg.B):
        assert hm.ed25519_verify(shares[0][w].public_key, msgs[w], sigs[w].tobytes())


def test_fused_step_matches_the_jax_golden():
    want = _golden(ENGINE_GOLDEN)["fused"]
    _, signer = _signer()
    frng = np.random.default_rng(eg.ENGINE["fused"])
    r64 = frng.integers(0, 256, (2, eg.B, 64), dtype=np.uint8)
    c64 = frng.integers(0, 256, (eg.B, 64), dtype=np.uint8)
    sigs, ok_R = eb.fused_sign_step(_t(r64), _t(c64), _t(signer.lamx))
    assert [bytes(r).hex() for r in _np(sigs)] == want["signatures"]
    assert _np(ok_R).tolist() == want["ok_R"]


@pytest.mark.parametrize("cohorts,lengths", [
    (1, (0, 1, 200, 32)),
    (2, (0, 1, 200, 32)),
    (2, (0, 1, 32, 32)),  # the second cohort's messages share one length
])
def test_ragged_messages_sign_the_same_bytes(cohorts, lengths):
    """A ragged batch hashes its challenges on the host, cohort by cohort;
    the bytes are those of the python-int signer on the same draws."""
    msgs = eg.messages(eg.B, eg.ENGINE["messages"])
    ragged = [m[:n] if n <= len(m) else bytes([n % 251]) * n
              for m, n in zip(msgs, lengths)]
    shares, signer = _signer(77)
    sigs, ok = signer.sign(ragged, cohorts=cohorts)
    assert ok.all()
    assert np.array_equal(sigs, _host_sign(shares, ragged, 77))


def test_signer_checks_shares_and_needs_a_device_without_a_gpu():
    shares = eb.dealer_keygen_batch(2, eg.UNIVERSE, 1, rng=SeededStream(9))
    with pytest.raises(ValueError, match="misaligned"):
        eb.BatchedCoSigners(eg.QUORUM, [shares[1], shares[0]], device="cpu")
    with pytest.raises(ValueError, match="not enough"):
        three = eb.dealer_keygen_batch(2, eg.UNIVERSE, 2, rng=SeededStream(9))
        eb.BatchedCoSigners(eg.QUORUM, three[:2], device="cpu")
    secp = [[type(s)(**{**s.__dict__, "key_type": "secp256k1"}) for s in row]
            for row in shares[:2]]
    with pytest.raises(ValueError, match="wrong key type"):
        eb.BatchedCoSigners(eg.QUORUM, secp, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eb.BatchedCoSigners(eg.QUORUM, shares[:2])


@pytest.mark.slow
def test_live_jax_engine_matches_the_golden_and_the_port():
    want = _golden(ENGINE_GOLDEN)
    assert eg.engine_record(jeb, jnp.asarray) == want
    assert eg.engine_record(eb, _t, device="cpu") == want


def write_golden() -> None:
    from mpcium_tpu.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
    from mpcium_tpu.protocol.runner import run_protocol

    GOLDENS.mkdir(parents=True, exist_ok=True)
    ENGINE_GOLDEN.write_text(json.dumps({
        "about": "EdDSA 2-of-3 signatures written by mpcium_tpu.engine.eddsa_batch "
                 "on the CPU (tests/test_torch_eddsa_batch.py --write-golden); "
                 "parameters in mpcium_tpu_torch/utils/eddsa_golden.py",
        "record": eg.engine_record(jeb, jnp.asarray),
    }, indent=1) + "\n")
    print("engine golden written", flush=True)
    PARTY_GOLDEN.write_text(json.dumps({
        "about": "Batched EdDSA party wire and results written by "
                 "mpcium_tpu.protocol.eddsa.batch_signing on the CPU "
                 "(tests/test_torch_eddsa_batch.py --write-golden); "
                 "parameters in mpcium_tpu_torch/utils/eddsa_golden.py",
        "record": eg.party_record(jeb, BatchedEDDSASigningParty, run_protocol),
    }, indent=1) + "\n")
    print("party golden written", flush=True)


if __name__ == "__main__" and "--write-golden" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    write_golden()
