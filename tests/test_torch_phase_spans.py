"""The port's engines trace their phases as the JAX engines do.

With tracing on, one engine call emits a ``phase:<name>`` span per
protocol phase (a track per cohort) and a ``host:<label>`` span per
pipeline host stage. The port's spans must equal the JAX package's for
the same call in names, count, tracks, nesting and attribute keys
(``utils/span_golden.py`` holds the record format and the cases), and
GG18's ``phase_times`` keys must equal JAX's. The JAX side is a
committed golden, since the JAX engines take minutes on the CPU; with
tracing off the port emits no span and never syncs.

Regenerate the golden with the JAX package (each case in a child
process, tens of minutes)::

    JAX_PLATFORMS=cpu python tests/test_torch_phase_spans.py --write-golden
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_golden_writer import child_record, pipe_host_down, setup_jax  # noqa: F401
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # run as a script (the golden writer's children)

from mpcium_tpu_torch.utils import span_golden as sg  # noqa: E402

torch.set_num_threads(1)  # tiny float64 matmuls: threads only contend

GOLDEN = ROOT / "mpcium_tpu_torch" / "data" / "goldens" / "phase_spans.json"
CASES = [*sg.EDDSA, *sg.GG18_OT, *sg.GG18_PAILLIER, *sg.DKG]


def _record(case: str, gb, eb, dkg, tracing, preparams, **kw) -> dict:
    if case in sg.EDDSA:
        return sg.eddsa_record(eb, tracing, case, **kw)
    if case in sg.GG18_OT:
        return sg.gg18_ot_record(gb, tracing, case, **kw)
    if case in sg.GG18_PAILLIER:
        return sg.gg18_paillier_record(gb, tracing, preparams(1024), case, **kw)
    return sg.dkg_record(dkg, tracing, case, **kw)


def _port_record(case: str) -> dict:
    from mpcium_tpu_torch.cluster import load_test_preparams
    from mpcium_tpu_torch.engine import dkg_batch, eddsa_batch, gg18_batch
    from mpcium_tpu_torch.utils import tracing

    return _record(case, gg18_batch, eddsa_batch, dkg_batch, tracing, load_test_preparams,
                   device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_engine_phase_spans_equal_the_jax_engines(case):
    want = json.loads(GOLDEN.read_text())["cases"][case]
    got = _port_record(case)
    assert got["order"] == want["order"]
    assert got["spans"] == want["spans"]
    assert got == want


def test_untraced_engine_emits_nothing_and_never_syncs(monkeypatch):
    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.utils import tracing

    emitted, synced = [], []
    # a sink left installed while tracing is off must receive nothing
    monkeypatch.setattr(tracing, "_sink", emitted.append)
    monkeypatch.setattr(tracing, "sync_tensors", lambda t: synced.append(t))
    assert not tracing.enabled()
    B, cohorts, kseed, sseed, mseed = sg.EDDSA["eddsa_b4_c2"]
    shares = eb.dealer_keygen_batch(B, sg.UNIVERSE, 1, rng=sg.SeededStream(kseed))
    signer = eb.BatchedCoSigners(sg.QUORUM, shares[:2], rng=sg.SeededStream(sseed),
                                 device="cpu")
    msgs = [bytes(32)] * B
    _sigs, ok = signer.sign(msgs, cohorts=cohorts)
    assert ok.all()
    assert emitted == [] and synced == []
    phases: dict = {}
    signer.sign(msgs, cohorts=cohorts, phase_times=phases)  # a dict alone turns timers on
    assert sorted(phases) == ["r1_nonce_commit", "r2_decommit_aggregate",
                              "r3_challenge_partials_combine", "verify"]
    assert len(synced) == 8 and emitted == []  # four marks per cohort; still no span


def test_phase_timer_matches_jax_timer_semantics():
    """The timer itself, against the JAX class: ids from the open span,
    the dict assigned (not added), numeric attrs flattened, and a mark
    without tensors does not sync."""
    from mpcium_tpu.utils import tracing as jt

    from mpcium_tpu_torch.utils import tracing as tt

    def run(tr):
        spans, phases, synced = [], {}, []
        tr.enable(sink=spans.append)
        try:
            with tr.span("outer"):
                pt = tr.PhaseTimer("eng", synced.append, phase_times=phases,
                                   node="engine", tid="eng:B4")
                pt.mark("a", np.zeros(1))
                pt.mark("a", host=1.5, ok=True, label="x")
                pt.mark("b")
        finally:
            tr.disable()
        rows = [(s["name"], s["tid"], s["node"], s["parent_id"] == spans[-1]["span_id"],
                 s["trace_id"] == spans[-1]["trace_id"], sorted(s["attrs"].items()))
                for s in spans]
        return rows, sorted(phases), phases["a_host"], len(synced)

    assert run(tt) == run(jt)
    off = tt.PhaseTimer("eng", lambda t: pytest.fail("synced while off"))
    off.mark("a", torch.zeros(1))
    assert not off.on


def write_golden() -> None:
    cases = {}
    for case in CASES:
        cases[case] = child_record(__file__, case)
        print(f"case {case}: {len(cases[case]['spans'])} spans", flush=True)
    GOLDEN.write_text(json.dumps({
        "about": "engine phase spans written by the mpcium_tpu engines on the CPU "
                 "(tests/test_torch_phase_spans.py --write-golden); format and "
                 "cases: mpcium_tpu_torch/utils/span_golden.py",
        "cases": cases,
    }, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
    elif "--golden-case" in sys.argv:
        setup_jax()
        from mpcium_tpu.cluster import load_test_preparams
        from mpcium_tpu.engine import dkg_batch, eddsa_batch, gg18_batch
        from mpcium_tpu.utils import tracing

        case = sys.argv[sys.argv.index("--golden-case") + 1]
        rec = _record(case, gg18_batch, eddsa_batch, dkg_batch, tracing,
                      lambda bits: load_test_preparams(bits=bits))
        print(json.dumps(rec))
