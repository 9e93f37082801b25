"""Deep profiling: the card's timeline, folded into the engines' phases.

The port's counterpart of the JAX package's ``perf/profile.py``.
``MPCIUM_PROFILE=1`` arms :func:`device_profile`, a context manager
around ``torch.profiler`` with CUDA activity that captures the device
timeline of the wrapped region and writes its device events — kernels,
memory copies and memory sets, nothing of the host — as one
``*.trace.json.gz`` under ``logdir`` (and beside it ``*.export.json``:
the seconds the profiler's stop, the reading of its events and the write
took). :func:`fold_device_ops` then walks
the captures there, attributes each device event's time to the
``phase:`` span whose window its midpoint lands in, and returns
``{"<phase>_device_op_s": seconds}``: the phase table and the device's
own time in one.

Unlike the JAX copy, an armed capture never quietly yields False: it
captures or raises (no CUDA device for ``device=None``, a profiler already
running or one that did not start, a torch without the event fields read
here), so a run can
never report a fold that silently lacks the device. Disabled, it yields
False and touches nothing. ``device="cpu"`` captures the host activity
only, so its capture holds no device event and folds to ``{}``.
"""
from __future__ import annotations

import glob
import gzip
import itertools
import json
import os
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

PROFILE_ENV = "MPCIUM_PROFILE"
# the trace categories (kineto activity types) of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_captures = itertools.count()


def profiling_enabled() -> bool:
    return os.environ.get(PROFILE_ENV, "") == "1"


def _category(e, cuda) -> Optional[str]:
    """A device event's trace category where torch reports it (its
    kineto activity type); else (torch 2.11) by its name: kineto names
    copies ``Memcpy …`` and sets ``Memset …``, and a device sync event
    ``… Sync`` / ``Stream Wait Event``. Host events (runtime calls,
    overhead) lie on the CPU: None."""
    if e.device_type() != cuda:
        return None
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.is_user_annotation():
        return None
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    if name.endswith("Sync") or name == "Stream Wait Event":
        return "cuda_sync"
    return "kernel"


def _device_events(prof) -> List[dict]:
    """The capture's device events as Chrome-trace complete events, one
    track per (device, stream), plus a ``process_name`` per device."""
    from torch.autograd import DeviceType

    out: List[dict] = []
    devices = set()
    for e in prof.profiler.kineto_results.events():
        cat = _category(e, DeviceType.CUDA)
        if cat not in DEVICE_CATS:
            continue
        devices.add(e.device_index())
        out.append({
            "ph": "X", "cat": cat, "name": e.name(), "pid": e.device_index(),
            "tid": e.device_resource_id(), "ts": e.start_ns() / 1e3,
            "dur": e.duration_ns() / 1e3,
        })
    meta = [{"ph": "M", "name": "process_name", "pid": d, "tid": 0,
             "args": {"name": f"GPU {d}"}} for d in sorted(devices)]
    return meta + out


@contextmanager
def device_profile(logdir: str, device=None) -> Iterator[bool]:
    """Capture the device timeline of the enclosed region into
    ``logdir``. Yields True while a capture runs, False when profiling
    is disabled. ``device``: where the region runs (None: the GPU, and
    it raises when there is none). The capture is written when the
    region ends without an exception."""
    if not profiling_enabled():
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve

    dev = resolve(device)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    if torch._C._autograd._profiler_enabled():
        raise RuntimeError("device_profile: a profiler is already capturing in this process")
    prof = profile(activities=[activity], record_shapes=False, with_stack=False,
                   profile_memory=False, with_flops=False, with_modules=False)
    prof.start()
    if not torch._C._autograd._profiler_enabled():
        raise RuntimeError("device_profile: torch.profiler did not start")
    try:
        yield True
    except BaseException:
        prof.stop()
        raise
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    prof.stop()
    t1 = time.perf_counter()
    events = _device_events(prof)
    t2 = time.perf_counter()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"capture_{os.getpid()}_{next(_captures)}.trace.json.gz")
    # one encode and the fastest compression: a sign's capture holds
    # millions of events
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write(json.dumps({"traceEvents": events}))
    # beside it, the seconds each step of the export took
    with open(path[:-len(".trace.json.gz")] + ".export.json", "w") as f:
        json.dump({"stop_s": t1 - t0, "read_s": t2 - t1,
                   "write_s": time.perf_counter() - t2, "events": len(events)}, f)


def _load_trace_events(logdir: str) -> List[dict]:
    events: List[dict] = []
    for path in sorted(glob.glob(
            os.path.join(logdir, "**", "*.trace.json.gz"), recursive=True)):
        try:
            with gzip.open(path, "rt") as f:
                doc = json.load(f)
            events.extend(doc.get("traceEvents") or [])
        except (OSError, EOFError, ValueError):  # a torn capture file yields nothing
            continue
    return events


def _device_pids(events: List[dict]) -> set:
    """Pids whose process_name metadata names a device timeline (the JAX
    package's rule for an XLA capture; host threads stay excluded)."""
    pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pname = str((e.get("args") or {}).get("name", "")).lower()
            if any(t in pname for t in ("tpu", "gpu", "device", "/device:",
                                        "xla")):
                if "host" not in pname and "cpu" not in pname:
                    pids.add(e.get("pid"))
    return pids


def device_ops(logdir: str) -> List[dict]:
    """Every complete device event of the captures under ``logdir``. An
    event with a category is a device event when the category is one of
    DEVICE_CATS (torch's); one without, when its process is a device
    timeline (the JAX package's rule)."""
    events = _load_trace_events(logdir)
    dev_pids = _device_pids(events)
    return [e for e in events
            if e.get("ph") == "X"
            and (e["cat"] in DEVICE_CATS if "cat" in e else e.get("pid") in dev_pids)
            and isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("dur"), (int, float))]


def fold_device_ops(spans: List[dict], logdir: str) -> Dict[str, float]:
    """Attribute device-op time from the captures under ``logdir`` to the
    mpctrace phase windows: :func:`fold_ops` over :func:`device_ops`."""
    return fold_ops(spans, device_ops(logdir))


def fold_ops(spans: List[dict], ops: List[dict]) -> Dict[str, float]:
    """The fold of device events ``ops`` into the phase windows.

    The profiler's clock and ``time.monotonic_ns`` share no epoch, so
    the two timelines are aligned at their starts, as in the JAX
    package: the first device op ↔ the first phase span's t0. Each
    device event whose midpoint falls inside a phase window adds its
    duration to that phase's ``<phase>_device_op_s``; events outside
    every window are left out. Returns {} when there is nothing to fold
    (no capture, no device event, no phase span)."""
    phases = [(s["name"][len("phase:"):], s["t0_ns"], s["t1_ns"])
              for s in spans if s.get("name", "").startswith("phase:")]
    if not phases or not ops:
        return {}
    trace_t0_us = min(e["ts"] for e in ops)
    span_t0_ns = min(t0 for _n, t0, _t1 in phases)
    out: Dict[str, float] = {}
    for e in ops:
        mid_ns = span_t0_ns + int((e["ts"] - trace_t0_us + e["dur"] / 2.0)
                                  * 1e3)
        for name, t0, t1 in phases:
            if t0 <= mid_ns < t1:
                out[f"{name}_device_op_s"] = (
                    out.get(f"{name}_device_op_s", 0.0) + e["dur"] / 1e6
                )
                break
    return {k: round(v, 6) for k, v in out.items()}


def default_logdir(root: Optional[str] = None) -> str:
    return os.path.join(root or os.getcwd(), ".mpcium_profile")
