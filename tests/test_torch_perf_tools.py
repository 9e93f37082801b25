"""The port's measurement tooling against the JAX package's: the span
folds of ``utils/tracing.py`` (``phase_share``, ``device_idle_fraction``,
``clean_attrs`` and declassification), ``perf/profile.py`` (the device
fold, the switch, the capture that captures or raises),
``perf/statcheck.py``, the rows of ``perf/microbench.py``,
``perf/envfp.fingerprint_key`` and ``utils/annotations``. Inputs are
seeded synthetic spans, captures and samples; no timing is gated."""
from __future__ import annotations

import gzip
import json
import os
import threading

import numpy as np
import pytest
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)
import torch

from mpcium_tpu.perf import envfp as jenvfp
from mpcium_tpu.perf import microbench as jmicro
from mpcium_tpu.perf import profile as jprofile
from mpcium_tpu.perf import statcheck as jstat
from mpcium_tpu.utils import annotations as jann
from mpcium_tpu.utils import tracing as jtr

from mpcium_tpu_torch.perf import envfp, microbench, profile, statcheck
from mpcium_tpu_torch.utils import annotations, tracing

SEEDS = range(6)


# ---------------------------------------------------------------------------
# seeded synthetic spans
# ---------------------------------------------------------------------------


def _span(name, t0, t1, tid="main", **attrs):
    return {"name": name, "t0_ns": int(t0), "t1_ns": int(t1), "trace_id": "t" * 16,
            "span_id": "s", "parent_id": None, "node": "engine", "tid": tid,
            "kind": "X", "attrs": attrs}


def _synthetic_spans(seed: int) -> list:
    """Phase spans on a few cohort tracks (overlapping across tracks),
    host stages between them, and spans the folds must ignore; numeric,
    boolean and string attrs."""
    rng = np.random.default_rng(seed)
    spans = []
    for c in range(int(rng.integers(1, 4))):
        t = int(rng.integers(0, 5_000_000))
        for name in ("r1", "r2", "r3", "r2"):  # a repeated name sums
            dt = int(rng.integers(1, 3_000_000))
            attrs = {}
            if rng.random() < 0.4:
                attrs = {"host": float(rng.random()), "chunks": int(rng.integers(1, 5)),
                         "ok": bool(rng.random() < 0.5), "label": "x"}
            spans.append(_span(f"phase:{name}", t, t + dt, tid=f"e:c{c}", **attrs))
            t += dt + int(rng.integers(0, 2_000_000))
            if rng.random() < 0.5:
                h = int(rng.integers(1, 1_000_000))
                spans.append(_span("host:sig_egress", t, t + h, cohort=c))
                t += h
    spans.append(_span("compile:e", 0, 10_000_000))
    spans.append(_span("session", 1, 2))
    rng.shuffle(spans)
    return spans


EDGE_SPANS = {
    "none": [],
    "host_only": [_span("host:a", 0, 10), _span("host:b", 5, 20, cohort=1)],
    "others_only": [_span("compile:x", 0, 10), _span("session", 3, 4)],
    "same_window": [_span("phase:a", 0, 10), _span("phase:a", 0, 10, tid="c1")],
    "nested": [_span("phase:a", 0, 100), _span("phase:b", 10, 20), _span("host:h", 100, 150)],
    "zero_width": [_span("phase:a", 5, 5)],
}


@pytest.mark.parametrize("seed", SEEDS)
def test_span_folds_agree_with_jax_on_seeded_spans(seed):
    spans = _synthetic_spans(seed)
    assert tracing.phase_share(spans) == jtr.phase_share(spans)
    assert tracing.device_idle_fraction(spans) == jtr.device_idle_fraction(spans)


@pytest.mark.parametrize("case", sorted(EDGE_SPANS))
def test_span_folds_agree_with_jax_on_edge_cases(case):
    spans = EDGE_SPANS[case]
    assert tracing.phase_share(spans) == jtr.phase_share(spans)
    assert tracing.device_idle_fraction(spans) == jtr.device_idle_fraction(spans)


def test_span_folds_read_overlap_as_a_union_and_mark_no_spans():
    spans = [_span("phase:a", 0, 60), _span("phase:a", 40, 100, tid="c1"),
             _span("host:h", 100, 200, cohort=0)]
    assert tracing.device_idle_fraction(spans) == 0.5
    assert tracing.phase_share(spans) == {"a": 120 / 1e9, "host_h": 100 / 1e9,
                                          "host_h_cohort": 0}
    assert tracing.phase_share([]) == {"no_spans": 0.0}


ATTRS = {"share": 7, "nonce": b"\x01", "seed": 3, "host": 1.5, "cohort": 0,
         "label": "x", "obj": object(), "flag": True, "none": None, "shape": (4, 2)}


def test_clean_attrs_and_declassification_agree_with_jax(monkeypatch):
    monkeypatch.setattr(tracing, "_DECLASSIFIED_ATTRS", {})
    monkeypatch.setattr(jtr, "_DECLASSIFIED_ATTRS", {})
    assert tracing.clean_attrs(ATTRS) == jtr.clean_attrs(ATTRS)
    assert tracing.clean_attrs(ATTRS)["share"] == "<refused:secret-name>"
    for mod in (tracing, jtr):
        with pytest.raises(ValueError, match="requires a reason"):
            mod.declassify_attr("seed", " ")
        mod.declassify_attr("seed", "a drill's public plan seed")
    assert tracing.declassified_attrs() == jtr.declassified_attrs() == {
        "seed": "a drill's public plan seed"}
    assert tracing.clean_attrs(ATTRS) == jtr.clean_attrs(ATTRS)
    assert tracing.clean_attrs(ATTRS)["seed"] == 3
    assert tracing.clean_attrs(ATTRS)["share"] == "<refused:secret-name>"


def test_declassified_names_pass_into_spans(monkeypatch):
    monkeypatch.setattr(tracing, "_DECLASSIFIED_ATTRS", {})
    tracing.declassify_attr("seed", "public")
    spans = []
    tracing.enable(sink=spans.append)
    try:
        tracing.emit("e", 0, 1, seed=5, share=1)
    finally:
        tracing.disable()
    assert spans[0]["attrs"] == {"seed": 5, "share": "<refused:secret-name>"}


# ---------------------------------------------------------------------------
# perf/profile.py
# ---------------------------------------------------------------------------


def _write_capture(logdir, events, name="host.trace.json.gz"):
    d = os.path.join(logdir, "plugins", "profile", "run1")
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(d, name), "wt") as f:
        json.dump({"traceEvents": events}, f)


def _jax_shaped(seed: int) -> list:
    rng = np.random.default_rng(seed)
    ev = [{"ph": "M", "name": "process_name", "pid": 7, "tid": 0,
           "args": {"name": "/device:TPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 9, "tid": 0,
           "args": {"name": "python host threads"}}]
    for _ in range(int(rng.integers(5, 40))):
        ev.append({"ph": "X", "name": "fusion", "pid": int(rng.choice([7, 9])), "tid": 1,
                   "ts": float(rng.integers(0, 9000)), "dur": float(rng.integers(1, 900))})
    return ev


def _phases(seed: int) -> list:
    rng = np.random.default_rng(seed + 100)
    t, out = 1_000_000, []
    for name in ("r1", "r2", "r3"):
        dt = int(rng.integers(500_000, 4_000_000))
        out.append(_span(f"phase:{name}", t, t + dt))
        t += dt
    return out + [_span("host:h", t, t + 10)]


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_agrees_with_jax_on_a_jax_shaped_capture(tmp_path, seed):
    _write_capture(str(tmp_path), _jax_shaped(seed))
    spans = _phases(seed)
    got = profile.fold_device_ops(spans, str(tmp_path))
    assert got == jprofile.fold_device_ops(spans, str(tmp_path))
    assert got


def test_fold_reads_a_torch_shaped_capture_by_category(tmp_path):
    # phases [1 ms, 2 ms) and [2 ms, 4 ms) on the span clock; the trace
    # clock starts at 500 µs with the first device event
    spans = [_span("phase:r1", 1_000_000, 2_000_000), _span("phase:r2", 2_000_000, 4_000_000)]
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "kernel", "name": "void powmod_kernel<4>", "pid": 0, "tid": 7,
         "ts": 500.0, "dur": 400.0},                                       # → r1
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7,
         "ts": 1600.0, "dur": 1000.0},                                     # → r2
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 0, "tid": 7,
         "ts": 2000.0, "dur": 100.0},                                      # → r2
        {"ph": "X", "cat": "kernel", "name": "late", "pid": 0, "tid": 7,
         "ts": 9000.0, "dur": 50.0},                                       # outside
        # on the device's pid but not device work, and host events
        {"ph": "X", "cat": "gpu_user_annotation", "name": "a", "pid": 0, "tid": 7,
         "ts": 500.0, "dur": 3000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 400.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 1, "tid": 1,
         "ts": 300.0, "dur": 50.0},
    ]
    _write_capture(str(tmp_path), events)
    assert len(profile.device_ops(str(tmp_path))) == 4
    assert profile.fold_device_ops(spans, str(tmp_path)) == {
        "r1_device_op_s": pytest.approx(400 / 1e6),
        "r2_device_op_s": pytest.approx(1100 / 1e6)}


def test_fold_returns_empty_on_missing_pieces_like_jax(tmp_path):
    spans = [_span("phase:r1", 0, 1_000_000)]
    for mod in (profile, jprofile):
        assert mod.fold_device_ops(spans, str(tmp_path)) == {}
    d = tmp_path / "run"
    d.mkdir()
    (d / "bad.trace.json.gz").write_bytes(b"not gzip at all")
    for mod in (profile, jprofile):
        assert mod.fold_device_ops(spans, str(tmp_path)) == {}
    _write_capture(str(tmp_path), _jax_shaped(0))
    for mod in (profile, jprofile):
        assert mod.fold_device_ops([], str(tmp_path)) == {}


def test_profiling_is_off_by_default_like_jax(monkeypatch):
    monkeypatch.delenv(profile.PROFILE_ENV, raising=False)
    assert profile.PROFILE_ENV == jprofile.PROFILE_ENV == "MPCIUM_PROFILE"
    assert not profile.profiling_enabled()
    with profile.device_profile("/nonexistent") as on:
        assert on is False
    assert not os.path.exists("/nonexistent")
    monkeypatch.setenv(profile.PROFILE_ENV, "1")
    assert profile.profiling_enabled() and jprofile.profiling_enabled()
    assert profile.default_logdir("/r") == jprofile.default_logdir("/r") == "/r/.mpcium_profile"


def test_a_real_cpu_capture_holds_no_device_event(tmp_path, monkeypatch):
    monkeypatch.setenv(profile.PROFILE_ENV, "1")
    spans = []
    tracing.enable(sink=spans.append)
    try:
        with profile.device_profile(str(tmp_path), device="cpu") as on:
            pt = tracing.PhaseTimer("e", tracing.sync_tensors)
            x = torch.arange(4096, dtype=torch.float64)
            pt.mark("work", (x @ x).reshape(1))
    finally:
        tracing.disable()
    assert on is True
    files = list(tmp_path.rglob("*.trace.json.gz"))
    assert len(files) == 1
    with gzip.open(files[0], "rt") as f:
        assert json.load(f) == {"traceEvents": []}  # host ops are dropped
    export = json.loads(files[0].with_name(
        files[0].name.replace(".trace.json.gz", ".export.json")).read_text())
    assert sorted(export) == ["events", "read_s", "stop_s", "write_s"] and export["events"] == 0
    assert profile.device_ops(str(tmp_path)) == []
    assert profile.fold_device_ops(spans, str(tmp_path)) == {}


def test_an_armed_capture_that_cannot_start_raises(tmp_path, monkeypatch):
    monkeypatch.setenv(profile.PROFILE_ENV, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profile.device_profile(str(tmp_path)):  # None: the GPU, and there is none
            pass
    with profile.device_profile(str(tmp_path / "a"), device="cpu"):
        with pytest.raises(RuntimeError):
            with profile.device_profile(str(tmp_path / "b"), device="cpu"):
                pass
    assert not (tmp_path / "b").exists()


# ---------------------------------------------------------------------------
# perf/statcheck.py
# ---------------------------------------------------------------------------


def _samples(seed: int, n: int, scale: float = 1.0) -> list:
    rng = np.random.default_rng(seed)
    return [float(v) * scale for v in rng.lognormal(-7, 0.3, n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_statcheck_agrees_with_jax_on_seeded_samples(seed):
    a = _samples(seed, 30)
    b = _samples(seed + 50, 30, 1.0 + 0.2 * seed)
    ties = [round(v, 4) for v in a[:10]] * 2
    for x, y in ((a, b), (b, a), (ties, ties[::-1]), (a, [v * 1.5 for v in a])):
        assert statcheck.median(x) == jstat.median(x)
        assert statcheck.mann_whitney_p(x, y) == jstat.mann_whitney_p(x, y)
        assert statcheck.bootstrap_ratio_ci(x, y, seed=seed) == \
            jstat.bootstrap_ratio_ci(x, y, seed=seed)
        v, jv = statcheck.compare("row", x, y), jstat.compare("row", x, y)
        assert (v.regressed, v.p_value, v.ratio, v.ci, v.render()) == \
            (jv.regressed, jv.p_value, jv.ratio, jv.ci, jv.render())
    base = {"a": a, "b": b, "only_base": a}
    cur = {"a": a, "b": [v * 1.5 for v in b], "only_cur": b}
    g, jg = statcheck.gate(base, cur), jstat.gate(base, cur)
    assert g.notes == jg.notes
    assert [v.render() for v in g.verdicts] == [v.render() for v in jg.verdicts]
    assert (g.ok, [v.bench for v in g.regressions]) == (jg.ok, [v.bench for v in jg.regressions])
    with pytest.raises(ValueError):
        statcheck.median([])


def test_statcheck_gate_passes_itself_and_flags_a_scaled_copy():
    a = _samples(1, 30)
    assert statcheck.gate({"r": a}, {"r": a}).ok
    assert [v.bench for v in statcheck.gate({"r": a}, {"r": [v * 1.5 for v in a]}).regressions] \
        == ["r"]


# ---------------------------------------------------------------------------
# perf/microbench.py
# ---------------------------------------------------------------------------


def test_microbench_rows_are_the_jax_rows():
    assert sorted(microbench.ALL_BENCHES) == sorted(jmicro.ALL_BENCHES)
    assert microbench.DEFAULT_SAMPLES == jmicro.DEFAULT_SAMPLES


@pytest.mark.parametrize("row", sorted(jmicro.ALL_BENCHES))
def test_microbench_row_returns_positive_samples_on_the_cpu(row):
    threads = set(threading.enumerate())
    fn = microbench.ALL_BENCHES[row]
    out = fn(3, device="cpu") if row in microbench._DEVICE_ROWS else fn(3)
    assert len(out) == 3
    assert all(isinstance(v, float) and v > 0 for v in out)
    left = {t.name for t in set(threading.enumerate()) - threads}
    assert left <= {"pipe-host_0"}, left  # the wheel is closed; pipe-host lives on
    assert not tracing.enabled()


def test_device_rows_need_an_explicit_cpu_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for row in microbench._DEVICE_ROWS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            microbench.ALL_BENCHES[row](1)


# ---------------------------------------------------------------------------
# perf/envfp.fingerprint_key, utils/annotations
# ---------------------------------------------------------------------------

ENVS = [
    None, {},
    {"platform": "tpu", "host": "abc", "device_count": 4, "device_kind": "TPU v5 lite",
     "jax": "0.4.30"},
    {"platform": "cpu", "host": "abc", "device_count": 1, "device_kind": "cpu"},
    {"platform": "uninitialized", "host": "h"},
    {"host": "h", "device_count": 2},
    {"platform": "gpu", "host": "h1", "device_count": 1,
     "device_kind": "NVIDIA H100 80GB HBM3", "torch": "2.11.0+cu128", "cuda": "12.8"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
@pytest.mark.parametrize("hint", [None, "tpu", "cpu"])
def test_fingerprint_key_is_the_jax_key(env, hint):
    assert envfp.fingerprint_key(env, platform_hint=hint) == \
        jenvfp.fingerprint_key(env, platform_hint=hint)


def test_the_port_stamp_groups_by_platform():
    stamp = envfp.env_fingerprint()
    assert {"torch", "cuda"} <= set(stamp) and "jax" not in stamp
    key = envfp.fingerprint_key(stamp)
    assert key.startswith(f"{stamp['platform']}/{stamp['host']}")
    gpu = dict(ENVS[-1])
    assert envfp.fingerprint_key(gpu) == "gpu/h1/1xNVIDIA H100 80GB HBM3"
    assert envfp.fingerprint_key(None, platform_hint="gpu") == "gpu/unstamped"


def test_the_native_thread_pin_is_a_knob_as_in_jax(monkeypatch):
    """A host-route time depends on MPCIUM_NATIVE_THREADS, so the stamp
    carries it, as the JAX package's does; paths and secrets stay out."""
    monkeypatch.setenv("MPCIUM_NATIVE_THREADS", "3")
    monkeypatch.setenv("MPCIUM_OT_DEVICE", "0")
    monkeypatch.setenv("MPCIUM_BROKER_TOKEN", "secret")
    knobs = envfp.knob_snapshot()
    assert knobs["MPCIUM_NATIVE_THREADS"] == "3" == jenvfp.knob_snapshot()["MPCIUM_NATIVE_THREADS"]
    assert knobs["MPCIUM_OT_DEVICE"] == "0"
    assert "MPCIUM_BROKER_TOKEN" not in knobs
    assert envfp.env_fingerprint()["knobs"] == knobs


def test_annotations_secret_and_thread_prefixes_are_the_jax_ones():
    assert annotations.Secret[bytes] is bytes is jann.Secret[bytes]
    assert annotations.REGISTERED_THREAD_PREFIXES == jann.REGISTERED_THREAD_PREFIXES


class _KinetoStub:
    """A kineto event of a torch that reports no activity type."""

    def __init__(self, name, device_type, annotation=False):
        self._n, self._d, self._a = name, device_type, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_device_categories_without_the_activity_type():
    from torch.autograd import DeviceType

    cases = {
        ("void powmod_kernel<4>(int const*)", DeviceType.CUDA, False): "kernel",
        ("Memcpy HtoD (Pageable -> Device)", DeviceType.CUDA, False): "gpu_memcpy",
        ("Memset (Device)", DeviceType.CUDA, False): "gpu_memset",
        ("Stream Sync", DeviceType.CUDA, False): "cuda_sync",
        ("Stream Wait Event", DeviceType.CUDA, False): "cuda_sync",
        ("my_range", DeviceType.CUDA, True): None,
        ("cudaLaunchKernel", DeviceType.CPU, False): None,
        ("aten::mul", DeviceType.CPU, False): None,
    }
    for (name, dev, ann), want in cases.items():
        assert profile._category(_KinetoStub(name, dev, ann), DeviceType.CUDA) == want, name
    assert {c for c in cases.values() if c in profile.DEVICE_CATS} == set(profile.DEVICE_CATS)
