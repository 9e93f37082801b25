"""The compile ledger: every kernel build, written down where an operator
can see it (the port's counterpart of the JAX package's
``perf/compile_watch.py``).

The port compiles two kinds of thing: K0's CUDA library, built by nvcc
at its first use in a process (``ops/mulmod.build``), and the EdDSA
and GG18 engines' CUDA graphs, one captured per function and argument
shape (``engine/graphs``, the counterpart of XLA's per-shape
executables).
Both report here through the two-call ``begin`` / ``finish`` protocol;
each finish records one ledger entry::

    {"engine": "mulmod", "shape": "<source digest>", "platform": "cuda",
     "compile_s": 4.1, "cache": "miss", "at": "..."}
    {"engine": "eddsa.verify_signatures",
     "shape": "uint8[16, 64],uint8[16, 32],uint8[16, 64]@cuda:0", ...}
    {"engine": "gg18._blk_final", "shape": "int32[512, 22],...@cuda:0", ...}

``cache`` is ``hit`` when the shared library of that digest already
existed (another process, or an earlier run, built it) and ``miss`` when
this process ran nvcc; a graph is always a ``miss`` (graphs live in the
process that captured them). The entry is

- persisted as ``COMPILE_LEDGER.json`` under ``set_ledger_dir`` (the
  daemon points it at its db dir), rewritten on every finish;
- emitted as a ``compile:<engine>`` span (node ``engine``, tid
  ``compile``), so the build lands on the trace timeline;
- surfaced through :func:`health_summary`, the ``compile`` section of
  the daemon's health, with a warming/ready state: a node that is alive
  but still booting publishes ``warming``.

:func:`export_gauges` mirrors the summary into a metrics registry and
adds K0's launch and plain-call counters (``ops/mulmod.py``) and each
graphed function's captures and replays: inside a daemon they are what
shows the card at work. The JAX version's XLA cache probe and its
``COMPILE_SURFACE.json`` prediction have no counterpart.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils import tracing

LEDGER_BASENAME = "COMPILE_LEDGER.json"

_lock = threading.Lock()
_seen: set = set()  # (engine, shape) already ledgered in this process
_entries: List[dict] = []
_state = "ready"  # non-daemon default; run_node marks warming at boot
_ledger_dir: Optional[str] = None


class _Token:
    __slots__ = ("engine", "shape", "t0", "t0_ns", "meta")

    def __init__(self, engine: str, shape: str, meta: Dict[str, Any]) -> None:
        self.engine = engine
        self.shape = shape
        self.meta = meta
        self.t0 = time.perf_counter()
        self.t0_ns = tracing.now_ns()


def set_ledger_dir(path: Optional[str]) -> None:
    """Where ``COMPILE_LEDGER.json`` goes (the daemon's db dir); None
    keeps the ledger in memory only."""
    global _ledger_dir
    with _lock:
        _ledger_dir = path


def ledger_path() -> Optional[str]:
    with _lock:
        d = _ledger_dir
    return os.path.join(d, LEDGER_BASENAME) if d else None


def begin(engine: str, shape: str, **meta: Any) -> Optional[_Token]:
    """Open a build observation for (engine, shape); None when this pair
    was already ledgered in this process."""
    key = (engine, shape)
    with _lock:
        if key in _seen:
            return None
        _seen.add(key)
    return _Token(engine, shape, meta)


def finish(token: Optional[_Token], cache: str) -> Optional[dict]:
    """Close an observation with its cache outcome (``hit`` / ``miss``):
    append the entry to the ledger (memory + JSON file) and emit the
    ``compile:<engine>`` span. Returns the entry."""
    if token is None:
        return None
    elapsed = time.perf_counter() - token.t0
    t1_ns = tracing.now_ns()
    entry = {
        "engine": token.engine,
        "shape": token.shape,
        "platform": "cuda",
        "compile_s": round(elapsed, 3),
        "cache": cache,
        "at": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
    }
    for k, v in token.meta.items():
        if isinstance(v, (str, int, float, bool)):
            entry.setdefault(k, v)
    with _lock:
        _entries.append(entry)
        snapshot = list(_entries)
    _write_ledger(snapshot)
    tracing.emit(
        f"compile:{token.engine}", token.t0_ns, t1_ns,
        node="engine", tid="compile",
        shape=token.shape, cache=cache, compile_s=entry["compile_s"],
        platform=entry["platform"],
    )
    return entry


def _write_ledger(snapshot: List[dict]) -> None:
    path = ledger_path()
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"entries": snapshot}, f, indent=1, sort_keys=True)
            f.write("\n")
    except OSError:
        pass  # ledgering must never take the kernel build down


def entries() -> List[dict]:
    """The ledger entries of this process, oldest first."""
    with _lock:
        return list(_entries)


def mark_warming() -> None:
    """Daemon boot: the node is alive but not serving yet."""
    global _state
    with _lock:
        _state = "warming"


def mark_ready() -> None:
    global _state
    with _lock:
        _state = "ready"


def health_summary() -> Dict[str, object]:
    """The ``compile`` section of the health payload: warming/ready state,
    hit/miss/seconds accounting, the most recent entry, and ``graphs``:
    captures and replays per graphed function that has captured
    (``engine/graphs.counts``)."""
    from ..engine import graphs

    with _lock:
        ents = list(_entries)
        state = _state
    return {
        "state": state,
        "compiles": len(ents),
        "cache_hits": sum(1 for e in ents if e["cache"] == "hit"),
        "cache_misses": sum(1 for e in ents if e["cache"] == "miss"),
        "total_compile_s": round(sum(e["compile_s"] for e in ents), 3),
        "last": ents[-1] if ents else None,
        "ledger": ledger_path(),
        "graphs": {k: v for k, v in graphs.counts().items() if v["captures"]},
    }


def export_gauges(metrics) -> None:
    """Mirror the summary into a ``MetricsRegistry`` as gauges, with K0's
    counters: ``k0.mulmod_launches[.n<width>]``,
    ``k0.powmod_launches[.<mode>_n<width>]`` and ``k0.plain_calls``; and
    per graphed function that has captured, ``graphs.captures.<fn>`` and
    ``graphs.replays.<fn>``."""
    from ..ops import mulmod as K

    s = health_summary()
    metrics.gauge("compile.ready").set(1.0 if s["state"] == "ready" else 0.0)
    metrics.gauge("compile.count").set(float(s["compiles"]))
    metrics.gauge("compile.cache_hits").set(float(s["cache_hits"]))
    metrics.gauge("compile.cache_misses").set(float(s["cache_misses"]))
    metrics.gauge("compile.seconds_total").set(float(s["total_compile_s"]))
    with K._count_lock:
        launches, plain = K.launches, K.plain_calls
        by_width = dict(K.launches_by_width)
        by_mode = dict(K.powmod_launches_by_mode_width)
    metrics.gauge("k0.mulmod_launches").set(float(launches))
    for n, v in by_width.items():
        metrics.gauge(f"k0.mulmod_launches.n{n}").set(float(v))
    metrics.gauge("k0.powmod_launches").set(float(sum(by_mode.values())))
    for (mode, n), v in by_mode.items():
        metrics.gauge(f"k0.powmod_launches.{mode}_n{n}").set(float(v))
    metrics.gauge("k0.plain_calls").set(float(plain))
    for name, c in s["graphs"].items():
        metrics.gauge(f"graphs.captures.{name}").set(float(c["captures"]))
        metrics.gauge(f"graphs.replays.{name}").set(float(c["replays"]))


def reset() -> None:
    """Test hook: forget every entry, pair and state override."""
    global _state, _ledger_dir
    with _lock:
        _seen.clear()
        _entries.clear()
        _state = "ready"
        _ledger_dir = None
