#!/usr/bin/env python3
"""The port's trace gate: its flight-recorder sample and tracing's
transcript neutrality.

The port of ``scripts/trace_check.py``. Three checks:

1. The committed sample ``mpcium_tpu_torch/data/trace_sample.json``
   validates against the Chrome trace-event schema
   (``mpcium_tpu_torch/trace/schema.validate_chrome``) and covers every
   layer the tracing instruments (``REQUIRED_SPAN_LAYERS``): scheduler
   intake, queue and dispatch, protocol rounds, sessions and device
   phases.
2. Transcript equality: the same seeded B=2 batched EdDSA sign
   (``BatchedEDDSASigningParty``, two parties), traced and untraced,
   gives the same round transcript and the same signatures.
3. Unless ``--no-sweep``: the port's static gate,
   ``scripts/torch_check_all.py``.

``--regen`` first rebuilds the sample from a miniature soak
(``mpcium_tpu_torch/soak.run_soak``: three nodes, batch signing through
the scheduler under the flight recorder, no chaos) on ``--device``. The
root's ``TRACE_sample.json`` is the JAX package's and is not touched.

    python scripts/torch_trace_check.py [--regen] [--no-sweep] [--device cpu]

Without a GPU and without ``--device cpu`` the checks that run a
protocol raise. Exit codes: 0 clean, 1 any check failed.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
ROOT = _HERE.parent
sys.path.insert(0, str(ROOT))

SAMPLE = ROOT / "mpcium_tpu_torch" / "data" / "trace_sample.json"

# the layers the sample must witness
REQUIRED_SPAN_LAYERS = {
    "scheduler intake": lambda n: n == "intake",
    "scheduler queue": lambda n: n == "queue",
    "scheduler dispatch": lambda n: n == "dispatch",
    "protocol rounds": lambda n: n.startswith("round:"),
    "sessions": lambda n: n == "session",
    "device phases": lambda n: n.startswith("phase:"),
}


def regen_sample(device=None, path: Path = SAMPLE) -> dict:
    """Rebuild the sample: a miniature batch-signing soak (no chaos)
    through the whole cluster under the armed flight recorder."""
    from mpcium_tpu_torch.soak import SoakConfig, run_soak
    from mpcium_tpu_torch.utils import log

    log.init(level="ERROR")
    report = run_soak(SoakConfig(
        n_nodes=3, threshold=1, n_wallets=2,
        n_sign=4, burst_size=4, burst_gap_s=0.05, seed=42,
        interactive_fraction=0.5,
        chaos="",  # the sample documents the span model, not chaos
        batch_window_s=0.2, wait_timeout_s=420.0,
    ), device=device)
    doc = report["trace"]
    doc["otherData"]["sample"] = "regenerate with: python scripts/torch_trace_check.py --regen"
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def check_sample(path: Path = SAMPLE) -> list:
    from mpcium_tpu_torch.trace import validate_chrome

    name = path.name
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{name} unreadable: {e!r} "
                f"(regenerate: python scripts/torch_trace_check.py --regen)"]
    try:
        n = validate_chrome(doc)
    except Exception as e:  # noqa: BLE001 — collect, don't crash the gate
        return [f"{name} schema: {e}"]
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") != "M"}
    errors = [f"{name}: no span for layer {layer!r} (have {sorted(names)[:12]}...)"
              for layer, pred in REQUIRED_SPAN_LAYERS.items()
              if not any(pred(s) for s in names)]
    if not errors:
        print(f"trace-check: sample OK ({n} events, {len(names)} span names)")
    return errors


class DetRng:
    """A seeded stand-in for ``secrets`` (the parties draw through
    ``token_bytes`` and ``randbelow``)."""

    def __init__(self, seed):
        self._r = random.Random(seed)

    def token_bytes(self, n):
        return self._r.randbytes(n)

    def randbelow(self, n):
        return self._r.randrange(n)


def eddsa_run(traced: bool, device=None):
    """One seeded 2-party B=2 batched EdDSA sign on ``device`` →
    (round transcript, signatures by party, spans emitted)."""
    import numpy as np

    from mpcium_tpu_torch.engine import eddsa_batch as eb
    from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
    from mpcium_tpu_torch.protocol.runner import run_protocol
    from mpcium_tpu_torch.utils import tracing

    spans: list = []
    transcript: list = []
    ids = ["n0", "n1"]
    shares = eb.dealer_keygen_batch(2, ids, 1, rng=DetRng(5))
    if traced:
        tracing.enable(sink=spans.append)
    try:
        parties = {
            pid: BatchedEDDSASigningParty("trace-eq", pid, ids, shares[i],
                                          [b"a" * 32, b"b" * 32], rng=DetRng(11 + i),
                                          device=device)
            for i, pid in enumerate(ids)
        }
        for p in parties.values():
            orig = p.receive

            def rec(m, _o=orig):
                transcript.append((m.round, m.from_id, m.to, repr(m.payload)))
                return _o(m)

            p.receive = rec
        run_protocol(parties)
    finally:
        tracing.disable()
    sigs = {p: np.asarray(parties[p].result["signatures"]).tobytes() for p in parties}
    return transcript, sigs, spans


def check_transcript_equality(device=None) -> list:
    """The same seeded run, traced and untraced: round transcripts and
    signatures must be identical."""
    t_off, sig_off, s_off = eddsa_run(False, device)
    t_on, sig_on, s_on = eddsa_run(True, device)
    errors = []
    if s_off:
        errors.append("transcript-equality: spans emitted while disabled")
    if not s_on:
        errors.append("transcript-equality: no spans emitted while traced")
    if t_off != t_on:
        errors.append("transcript-equality: traced run CHANGED the round transcript")
    if sig_off != sig_on:
        errors.append("transcript-equality: traced run CHANGED the signatures")
    if not errors:
        print(f"trace-check: transcript equality OK ({len(t_off)} messages, {len(s_on)} spans)")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regen", action="store_true",
                    help="rebuild the port's sample from a live run first")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the static sweep (scripts/torch_check_all.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    from mpcium_tpu_torch.device import resolve

    dev = resolve(args.device)  # raises without a GPU unless told 'cpu'
    errors = []
    if args.regen:
        regen_sample(dev)
    errors += check_sample()
    errors += check_transcript_equality(dev)

    if not args.no_sweep:
        sys.path.insert(0, str(_HERE))
        import torch_check_all

        rc = torch_check_all.main([])
        if rc != 0:
            errors.append(f"static sweep failed (torch_check_all rc={rc})")

    for e in errors:
        print(f"TRACE-CHECK FAIL: {e}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
