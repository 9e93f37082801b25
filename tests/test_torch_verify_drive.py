"""The port's verify drive (``scripts/torch_verify_drive.py``): its AEAD
stage live, its OpenSSL verifiers against the committed goldens, its
refusal to run without a GPU unless given ``--device cpu``, and (slow)
the whole drive on the CPU."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from cryptography.exceptions import InvalidSignature

from torch_tcp import tcp_threads_down  # noqa: F401 — module fixture

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch_verify_drive.py"
GOLDENS = ROOT / "mpcium_tpu_torch" / "data" / "goldens"
sys.path.insert(0, str(ROOT / "scripts"))

import torch_verify_drive as vd  # noqa: E402


def _flipped(hex_str: str, i: int) -> str:
    b = bytearray(bytes.fromhex(hex_str))
    b[i] ^= 0x01
    return b.hex()


def _ecdsa_golden():
    doc = json.loads((GOLDENS / "gg18_paillier_b2_1024.json").read_text())
    return [row for case in doc["cases"]
            for row in zip(case["public_keys"], case["digests"], case["r"], case["s"])]


def _ed25519_golden():
    rec = json.loads((GOLDENS / "eddsa_party_b4.json").read_text())["record"]
    return list(zip(rec["public_keys"], rec["messages"], rec["results"]["node0"]["signatures"]))


def test_aead_stage_round_trips_over_the_encrypted_broker():
    assert vd.stage_aead() == {"roundtrip": True, "encrypt": True}


def test_openssl_accepts_the_golden_ecdsa_signatures_and_rejects_each_flipped_byte():
    rows = _ecdsa_golden()
    assert len(rows) == 6  # the B=2 and B=4 cases
    for pub, digest, r, s in rows:
        vd.verify_ecdsa(pub, bytes.fromhex(digest), r, s)
        sig = r + s
        for i in range(64):
            bad = _flipped(sig, i)
            with pytest.raises(InvalidSignature):
                vd.verify_ecdsa(pub, bytes.fromhex(digest), bad[:64], bad[64:])


def test_openssl_accepts_the_golden_ed25519_signatures_and_rejects_each_flipped_byte():
    rows = _ed25519_golden()
    assert len(rows) == 4
    for pub, msg, sig in rows:
        vd.verify_ed25519(pub, bytes.fromhex(msg), sig)
        for i in range(64):
            with pytest.raises(InvalidSignature):
                vd.verify_ed25519(pub, bytes.fromhex(msg), _flipped(sig, i))


def test_k0_counters_snapshot_is_json_keyed(monkeypatch):
    from mpcium_tpu_torch.ops import mulmod as K

    monkeypatch.setattr(K, "launches", 3)
    monkeypatch.setattr(K, "plain_calls", 2)
    monkeypatch.setattr(K, "launches_by_width", {608: 2, 320: 1})
    monkeypatch.setattr(K, "powmod_launches_by_mode_width", {("row", 608): 4, ("comb", 320): 5})
    snap = K.counters()
    assert snap == {"launches": 3, "launches_by_width": {"n320": 1, "n608": 2},
                    "powmod_launches_by_mode_width": {"comb_n320": 5, "row_n608": 4},
                    "plain_calls": 2}
    assert json.loads(json.dumps(snap)) == snap


def test_without_a_gpu_it_exits_before_any_work():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the drive runs there")
    r = subprocess.run([sys.executable, str(SCRIPT)], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "runs on a CUDA GPU" in r.stderr
    assert '"stage"' not in r.stdout and "VERIFY-DRIVE" not in r.stdout


@pytest.mark.slow
def test_whole_drive_on_the_cpu():
    """The four stages through the plain path (~7 min: the GG18 batch of
    2 runs K0's plain powmod on the CPU)."""
    r = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1800)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert [ln["stage"] for ln in lines] == ["dkg", "sign", "reshare", "aead"]
    assert all(ln["ok"] for ln in lines)
    sign = lines[1]
    assert sign["verified_openssl"] == 4
    assert sign["k0"]["launches"] == 0 and sign["k0"]["plain_calls"] > 0
    assert sign["k0"]["launches_by_width"] == {} == sign["k0"]["powmod_launches_by_mode_width"]
    assert lines[2]["epoch"] == 1 and lines[2]["threshold"] == 2
    assert r.stdout.rstrip().endswith("VERIFY-DRIVE: ALL OK")


def test_tools_script_holds_the_drive_to_k0_on_the_gpu():
    """``scripts/torch_tools_alone.py`` fails the drive on the card unless
    its sign stage launched K0 and called no plain version."""
    import torch_tools_alone as ta

    def sign(launches, powmod, plain):
        return {"stage": "sign", "k0": {"launches": launches, "launches_by_width": {},
                                         "powmod_launches_by_mode_width": powmod,
                                         "plain_calls": plain}}

    assert ta._k0_check([sign(0, {"row_n608": 2}, 0)], cpu=False) is None
    assert ta._k0_check([sign(4, {}, 0)], cpu=False) is None
    assert "launches 0" in ta._k0_check([sign(0, {}, 0)], cpu=False)
    assert "plain_calls 3" in ta._k0_check([sign(4, {}, 3)], cpu=False)
    assert ta._k0_check([sign(0, {}, 693)], cpu=True) is None
    assert ta._k0_check([{"stage": "dkg"}], cpu=False) == "no sign stage line"
    out = [(1.0, json.dumps(sign(1, {}, 0))), (1.5, "VERIFY-DRIVE: ALL OK")]
    assert ta._result_lines("verify_drive", out) == [sign(1, {}, 0), "VERIFY-DRIVE: ALL OK"]
