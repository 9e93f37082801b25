"""The port's trace gate (``scripts/torch_trace_check.py``): its
committed sample, JAX's sample under the port's schema, and tracing's
transcript neutrality, held to the JAX party's signatures."""
from __future__ import annotations

import json
import random
import sys
from pathlib import Path

import numpy as np
import pytest

from mpcium_tpu.engine import eddsa_batch as jeb
from mpcium_tpu.protocol.eddsa.batch_signing import BatchedEDDSASigningParty as JParty
from mpcium_tpu.protocol.runner import run_protocol as jrun

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_trace_check as tc  # noqa: E402


def test_committed_port_sample_passes_with_every_layer(capsys):
    assert tc.SAMPLE == ROOT / "mpcium_tpu_torch" / "data" / "trace_sample.json"
    assert tc.check_sample() == []
    assert "trace-check: sample OK" in capsys.readouterr().out
    doc = json.loads(tc.SAMPLE.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") != "M"}
    for layer, pred in tc.REQUIRED_SPAN_LAYERS.items():
        assert any(pred(n) for n in names), layer


@pytest.mark.parametrize("layer", sorted(tc.REQUIRED_SPAN_LAYERS))
def test_a_sample_without_one_layer_fails(tmp_path, layer):
    doc = json.loads(tc.SAMPLE.read_text())
    pred = tc.REQUIRED_SPAN_LAYERS[layer]
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("ph") == "M" or not pred(e["name"])]
    path = tmp_path / "stripped.json"
    path.write_text(json.dumps(doc))
    errors = tc.check_sample(path)
    assert len(errors) == 1 and repr(layer) in errors[0], errors


def test_unreadable_or_malformed_sample_fails(tmp_path):
    assert "unreadable" in tc.check_sample(tmp_path / "missing.json")[0]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "x", "ph": "X"}]}))
    assert "schema" in tc.check_sample(bad)[0]


def test_jax_sample_validates_under_the_port_schema():
    assert tc.check_sample(ROOT / "TRACE_sample.json") == []


def _jax_signatures():
    class DetRng:
        def __init__(self, seed):
            self._r = random.Random(seed)

        def token_bytes(self, n):
            return self._r.randbytes(n)

        def randbelow(self, n):
            return self._r.randrange(n)

    ids = ["n0", "n1"]
    shares = jeb.dealer_keygen_batch(2, ids, 1, rng=DetRng(5))
    parties = {pid: JParty("trace-eq", pid, ids, shares[i], [b"a" * 32, b"b" * 32],
                           rng=DetRng(11 + i)) for i, pid in enumerate(ids)}
    jrun(parties)
    return {p: np.asarray(parties[p].result["signatures"]).tobytes() for p in parties}


def test_traced_and_untraced_runs_are_equal_and_sign_as_jax_does(capsys):
    assert tc.check_transcript_equality("cpu") == []
    assert "transcript equality OK" in capsys.readouterr().out
    transcript, sigs, spans = tc.eddsa_run(True, "cpu")
    assert spans and len(transcript) == 6
    assert sigs == _jax_signatures()
