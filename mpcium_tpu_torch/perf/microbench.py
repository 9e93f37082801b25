"""The perfcheck micro-benches over the port: fast, hot-path-shaped.

The port's copy of the JAX package's ``perf/microbench.py``: the same
ten rows under the same names, each returning a list of per-sample wall
seconds for ``statcheck`` to compare. The host rows time the port's own
code or the same stdlib work; the device rows time the port's torch
counterparts of the JAX kernels on ``device`` (None: the GPU, and it
raises without one), finishing each sample with
``torch.cuda.synchronize`` where JAX calls ``block_until_ready``:

- ``field_mulmod``, ``sha256_block``, ``sha512_block``: host field
  arithmetic and hashing (python ints, hashlib);
- ``wheel_latency``: schedule→fire latency of the scheduler's
  ``_TimingWheel``, each sample the best of three hops (JAX's row takes
  one hop a sample; on the card's shared host its tail let a 1.5× copy
  pass the gate);
- ``span_overhead``: the port's span open/close cost with tracing armed;
- ``prg_expand_device`` / ``ot_transpose_device``: ``hash_suite.prg_expand``
  and ``ot_transpose`` (the IKNP PRG and the packed bit transpose);
- ``ot_kos_check_device``: ``mta_ot._k_kos_tags`` and ``_k_kos_verify``
  at one lane;
- ``pipeline_handoff``: ``pipeline.run_counter_phase`` over stub rounds;
- ``donated_round_step``: the ``st = step(st)`` rebind of a dict of
  (16, 8) planes, 8 steps on the device (torch has no buffer donation:
  the row times the same rebind chain without it).

Samples use best-of-k inner reps to shave scheduler noise off the floor;
the statistics in statcheck absorb what remains. The device rows import
torch inside the bench, so importing this module costs nothing.
"""
from __future__ import annotations

import hashlib
import itertools
import random
import threading
import time
from typing import Callable, Dict, List

# secp256k1 field prime — the modulus the host math actually uses
_P = 2**256 - 2**32 - 977

DEFAULT_SAMPLES = 30


def _timed_samples(fn: Callable[[], None], samples: int,
                   best_of: int = 3) -> List[float]:
    """Per sample: best wall time of ``best_of`` runs of ``fn`` — the
    minimum estimates the noise-free cost; sample-to-sample spread is
    what statcheck's rank test consumes."""
    fn()  # warm caches/allocators outside the measurement
    out = []
    for _ in range(samples):
        best = float("inf")
        for _ in range(best_of):
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
            if dt < best:
                best = dt
        out.append(best)
    return out


def _device_body(device, body: Callable[[], None]) -> Callable[[], None]:
    """``body`` then a wait for the device's queue (CUDA only)."""
    import torch

    if device.type != "cuda":
        return body

    def run() -> None:
        body()
        torch.cuda.synchronize(device)

    return run


def field_mulmod(samples: int = DEFAULT_SAMPLES, inner: int = 400) -> List[float]:
    rng = random.Random(0xF1E1D)
    xs = [rng.getrandbits(256) | 1 for _ in range(64)]

    def body() -> None:
        acc = 1
        for i in range(inner):
            acc = acc * xs[i & 63] % _P
        if acc == 0:  # keep the loop un-eliminable
            raise AssertionError("mulmod degenerated")

    return _timed_samples(body, samples)


def sha256_block(samples: int = DEFAULT_SAMPLES, kib: int = 96) -> List[float]:
    block = bytes(range(256)) * (kib * 4)  # kib KiB of fixed bytes

    def body() -> None:
        hashlib.sha256(block).digest()

    return _timed_samples(body, samples)


def wheel_latency(samples: int = DEFAULT_SAMPLES) -> List[float]:
    """Schedule→fire latency of the scheduler's timing wheel, measured
    on the real class, best of three hops a sample; the wheel's thread
    is closed before returning."""
    from ..consumers.batch_scheduler import _TimingWheel

    wheel = _TimingWheel(name="perfcheck-wheel")
    hops = itertools.count()

    def hop() -> None:
        fired = threading.Event()
        wheel.schedule(("s", next(hops)), 0.0, fired.set)
        if not fired.wait(2.0):
            raise RuntimeError("timing wheel never fired (perfcheck)")

    try:
        return _timed_samples(hop, samples)
    finally:
        wheel.close()


def span_overhead(samples: int = DEFAULT_SAMPLES, inner: int = 400) -> List[float]:
    """Cost of ``inner`` armed span open/closes into a null sink.
    Tracing state is saved and restored — the bench must not leave the
    process armed (or disarm a caller's recorder)."""
    from ..utils import tracing

    was_enabled = tracing.enabled()
    prev_sink = tracing._sink

    def body() -> None:
        for _ in range(inner):
            with tracing.span("perfcheck", kind="X"):
                pass

    tracing.enable(sink=lambda _s: None)
    try:
        return _timed_samples(body, samples)
    finally:
        if was_enabled:
            tracing.enable(sink=prev_sink)
        else:
            tracing.disable()


def sha512_block(samples: int = DEFAULT_SAMPLES, kib: int = 96) -> List[float]:
    """Host SHA-512 throughput — the hashlib lane of the Ed25519
    challenge hashing (ragged message batches)."""
    block = bytes(range(256)) * (kib * 4)  # kib KiB of fixed bytes

    def body() -> None:
        hashlib.sha512(block).digest()

    return _timed_samples(body, samples)


def prg_expand_device(samples: int = DEFAULT_SAMPLES, device=None) -> List[float]:
    """The device IKNP PRG expansion (``hash_suite.prg_expand``):
    KAPPA=128 seeds × 8 blocks, seeds already on the device."""
    import numpy as np

    from ..device import resolve
    from ..ops import hash_suite as hs

    dev = resolve(device)
    seeds = hs.as_bytes(np.frombuffer(
        hashlib.sha256(b"perfcheck-prg-seeds").digest() * 128, np.uint8
    ).reshape(128, 32), dev)
    prefix = b"perfcheck-prg|v1"
    return _timed_samples(_device_body(dev, lambda: hs.prg_expand(prefix, seeds, 8)), samples)


def ot_transpose_device(samples: int = DEFAULT_SAMPLES, device=None) -> List[float]:
    """The device packed bit-transpose (``hash_suite.ot_transpose``):
    (128, 512) packed bytes → (4096, 16), the per-chunk OT shape at B=16
    lanes."""
    import numpy as np

    from ..device import resolve
    from ..ops import hash_suite as hs

    dev = resolve(device)
    rng = random.Random(0x0707)
    packed = hs.as_bytes(np.frombuffer(
        bytes(rng.getrandbits(8) for _ in range(128 * 512)), np.uint8
    ).reshape(128, 512), dev)
    return _timed_samples(_device_body(dev, lambda: hs.ot_transpose(packed)), samples)


def ot_kos_check_device(samples: int = DEFAULT_SAMPLES, device=None) -> List[float]:
    """The KOS correlation-check pair (``mta_ot._k_kos_tags`` then
    ``_k_kos_verify``) at one batch lane (M = 256 OTs, κ = 128): the
    per-extension fixed cost every checked signing batch pays."""
    import numpy as np

    from ..device import resolve
    from ..ops import hash_suite as hs
    from ..protocol.ecdsa import mta_ot

    dev = resolve(device)

    def blob(tag: bytes, n: int) -> bytes:
        out = bytearray()
        ctr = 0
        while len(out) < n:
            out += hashlib.sha256(b"perfkos|%s|%d" % (tag, ctr)).digest()
            ctr += 1
        return bytes(out[:n])

    kappa, m = mta_ot.KAPPA, mta_ot.NBITS  # one lane

    def arr(tag: bytes, n: int, shape=None, bit: bool = False):
        a = np.frombuffer(blob(tag, n), np.uint8)
        a = a & 1 if bit else a
        return hs.as_bytes(a.reshape(shape) if shape else a, dev)

    rows_a = arr(b"ra", m * kappa // 8, (m, kappa // 8))
    rows_b = arr(b"rb", m * kappa // 8, (m, kappa // 8))
    x_bits = arr(b"xb", m, bit=True)
    delta = arr(b"dl", kappa, bit=True)
    U = arr(b"uu", kappa * 32, (kappa, 32))
    pref = mta_ot._fs_prefixes(b"perfkos|", b"kos", device=dev)

    def body() -> None:
        xbar, tbar = mta_ot._k_kos_tags(rows_a, x_bits, U, *pref)
        mta_ot._k_kos_verify(rows_b, delta, U, xbar, tbar, *pref)

    return _timed_samples(_device_body(dev, body), samples)


def pipeline_handoff(samples: int = DEFAULT_SAMPLES, rounds: int = 32) -> List[float]:
    """Handoff cost of the counter-phase cohort pipeline: one K=1 inline
    pass and one K=2 overlapped pass over ``rounds`` stub rounds whose
    device and host stages are no-ops, so the sample times only the
    machinery — generator round-robin, executor submit, future wait."""
    from ..engine import pipeline as pl

    def make_jobs(k: int):
        def make_job(ci: int):
            def job():
                acc = 0
                for r in range(rounds):
                    acc += yield ("stub", lambda r=r: r)
                return acc

            return job

        return [make_job(ci) for ci in range(k)]

    want = rounds * (rounds - 1) // 2

    def body() -> None:
        for k in (1, 2):
            outs = pl.run_counter_phase(make_jobs(k))
            if outs != [want] * k:  # keep the schedule un-eliminable
                raise AssertionError("stub pipeline produced wrong sums")

    return _timed_samples(body, samples)


def donated_round_step(samples: int = DEFAULT_SAMPLES, device=None) -> List[float]:
    """The carried round state of the pipeline: a dict of (16, 8) int32
    planes rebound ``st = step(st)`` 8 times on the device, where JAX
    donates the planes to a jitted step (``donate_argnums``). Torch has
    no buffer donation, so the row times the same rebind chain of eager
    steps without it."""
    import torch

    from ..device import resolve

    dev = resolve(device)

    def step(st):
        return {k: v + 1 for k, v in st.items()}

    def body() -> None:
        st = {k: torch.zeros((16, 8), dtype=torch.int32, device=dev) for k in ("s", "m", "r")}
        for _ in range(8):
            st = step(st)

    return _timed_samples(_device_body(dev, body), samples)


_DEVICE_ROWS = ("prg_expand_device", "ot_transpose_device", "ot_kos_check_device",
                "donated_round_step")

ALL_BENCHES: Dict[str, Callable[..., List[float]]] = {
    "field_mulmod": field_mulmod,
    "sha256_block": sha256_block,
    "sha512_block": sha512_block,
    "wheel_latency": wheel_latency,
    "span_overhead": span_overhead,
    "prg_expand_device": prg_expand_device,
    "ot_transpose_device": ot_transpose_device,
    "ot_kos_check_device": ot_kos_check_device,
    "pipeline_handoff": pipeline_handoff,
    "donated_round_step": donated_round_step,
}


def run_all(samples: int = DEFAULT_SAMPLES, device=None) -> Dict[str, List[float]]:
    """Every row, by name; the device rows run on ``device``."""
    return {name: (fn(samples, device=device) if name in _DEVICE_ROWS else fn(samples))
            for name, fn in sorted(ALL_BENCHES.items())}
