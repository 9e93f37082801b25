"""Per-shape CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package's EdDSA engine is nine jitted functions, its GG18
engine 26 jitted curve and round blocks; each call dispatches one
executable, compiled once per argument shape. Eager PyTorch dispatches
every tensor op from Python instead (77,432 of them for a 2-party EdDSA
sign of one session), and under one GIL shared by the nodes of a
cluster that enqueue is what a sign costs. :func:`graphed`
gives a function the jit's behaviour on the card: the first call for a
key captures the body into a CUDA graph, every later call copies its
inputs into the graph's static buffers and replays it with one launch.

The key is the function, the structure of its arguments (tuples, lists,
dicts and NamedTuples such as ``SecpPointJ``, as pytrees; a NamedTuple's
type is part of it), each tensor's shape and dtype, the device, and
the value of every non-tensor argument. The bodies stay plain torch:
what runs inside a graph is the code the CPU tests hold to the JAX
package byte for byte.

- **On CPU tensors** a graphed function calls its body: the plain path
  of the tests, chosen by the device and not by a failure. No counter
  moves.
- **A miss** (first call for a key on CUDA) runs the body once eagerly,
  which builds the per-device constant caches (``bn._arange``,
  ``ed._comb_table``, ``ed.scalar_ring``, ...) outside the graph; then
  captures it, under one process-wide capture lock, on a side stream of
  the device into a private memory pool, with
  ``capture_error_mode="thread_local"`` so other threads may keep
  launching eager work meanwhile; replays it once and holds the replay
  to the eager result, byte for byte. One compile-ledger entry
  (``perf/compile_watch``, engine ``<family>.<fn>``) records it. A
  capture that fails, or a first replay that differs, raises a
  ``RuntimeError`` naming the function and the key: nothing falls back
  to eager on CUDA.
- **A hit**, under the key's lock: the caller's stream waits on the
  entry's ``free`` event, the inputs are copied into the static input
  buffers (contiguous ``torch.empty`` tensors, so an expanded argument
  is materialised there), the graph replays, its outputs are cloned, and
  ``free`` is recorded on the caller's stream. The clones are returned,
  never the static buffers.
- **Nesting.** A graphed function called while this thread runs a
  graphed body (its capture or its eager run) runs its own body, as XLA
  inlines a nested jit.
- ``fn.eager`` runs the body with every nested graphed call eager too:
  the reference a comparison holds a replay to. No serving path calls it.

Per function, :func:`counts` gives ``captures`` (keys captured) and
``replays``: every top-level call on CUDA is one or the other, so the
body ran eagerly on CUDA exactly ``captures`` times. The daemon's health
carries them (``compile_watch.health_summary`` and its
gauges ``graphs.captures.<fn>`` / ``graphs.replays.<fn>``).

The capture backend is replaceable (:func:`use_backend`): the CPU tests
drive the key, buffer and lock logic through a stand-in whose "replay"
re-runs the body on the static inputs into the static outputs.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

_TLS = threading.local()
# held by a capture, and around every device-wide synchronize (no_capture):
# CUDA forbids synchronizing a device while one of its streams is being
# captured, and doing so from another thread invalidates the capture
_CAPTURE_LOCK = threading.RLock()
_REGISTRY: List["_Graphed"] = []


def _depth() -> int:
    return getattr(_TLS, "depth", 0)


def no_capture():
    """Hold off graph captures (waiting for one in another thread to
    end): wrap a device-wide ``torch.cuda.synchronize`` made beside
    graphed calls in it."""
    return _CAPTURE_LOCK


@contextlib.contextmanager
def eager_bodies() -> Iterator[None]:
    """Inside, every graphed function called from this thread runs its
    body (the eager reference of a comparison; captures run under it)."""
    _TLS.depth = _depth() + 1
    try:
        yield
    finally:
        _TLS.depth -= 1


# ---------------------------------------------------------------------------
# argument structure
# ---------------------------------------------------------------------------


def _flatten(obj, leaves: list):
    """(obj, leaves) → a hashable spec of ``obj``; its tensors appended to
    ``leaves``. Tuples, lists and dicts are containers; a NamedTuple
    (``SecpPointJ``) keeps its type in the spec and comes back as that
    type, any other tuple subclass as a plain tuple; a tensor is a leaf;
    anything else is part of the spec by value."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("T",)
    if isinstance(obj, dict):
        keys = tuple(obj)
        return ("D", keys, tuple(_flatten(obj[k], leaves) for k in keys))
    if isinstance(obj, tuple) and hasattr(type(obj), "_fields"):
        return ("NT", type(obj), tuple(_flatten(v, leaves) for v in obj))
    if isinstance(obj, (tuple, list)):
        return ("list" if isinstance(obj, list) else "tuple",
                tuple(_flatten(v, leaves) for v in obj))
    return ("V", type(obj), obj)  # a non-tensor argument: part of the key


def _unflatten(spec, leaves: Iterator[torch.Tensor]):
    tag = spec[0]
    if tag == "T":
        return next(leaves)
    if tag == "D":
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    if tag == "NT":
        return spec[1](*(_unflatten(s, leaves) for s in spec[2]))
    if tag == "tuple":
        return tuple(_unflatten(s, leaves) for s in spec[1])
    if tag == "list":
        return [_unflatten(s, leaves) for s in spec[1]]
    return spec[2]


def call_key(name: str, args: tuple, kwargs: dict):
    """The cache key of a call and what it is built from → ``(key,
    leaves, spec, device)``; ``device`` is the first CUDA (or, under a
    stand-in backend, handled) device among the tensors, else None."""
    leaves: list = []
    spec = _flatten((args, kwargs), leaves)
    dev = next((t.device for t in leaves if _BACKEND.handles(t.device)), None)
    meta = tuple((tuple(t.shape), t.dtype) for t in leaves)
    return (name, spec, meta, str(dev)), leaves, spec, dev


def _shape_str(leaves, spec, dev) -> str:
    """The ledger's ``shape`` of a key: dtype[shape] per tensor, the
    non-tensor values, the device."""
    vals = []

    def walk(s):
        if s[0] == "V":
            vals.append(repr(s[2]))
        elif s[0] in ("D", "NT"):
            for c in s[2]:
                walk(c)
        elif s[0] in ("tuple", "list"):
            for c in s[1]:
                walk(c)

    walk(spec)
    ts = ",".join(f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}" for t in leaves)
    return f"{ts}{'|' + ','.join(vals) if vals else ''}@{dev}"


# ---------------------------------------------------------------------------
# capture backends
# ---------------------------------------------------------------------------


class _EventFence:
    """A CUDA event that orders a key's static buffers across streams."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.event = torch.cuda.Event()

    def wait(self) -> None:
        torch.cuda.current_stream(self.dev).wait_event(self.event)

    def record(self) -> None:
        self.event.record(torch.cuda.current_stream(self.dev))


@functools.lru_cache(maxsize=None)
def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device=dev)


class CudaGraphs:
    """The card's backend: ``torch.cuda.CUDAGraph`` per key."""

    def handles(self, dev: torch.device) -> bool:
        return dev.type == "cuda"

    def capture(self, body: Callable[[], Any], dev: torch.device):
        """→ (graph, static outputs, pool bytes): ``body`` captured on a
        side stream of ``dev`` into a private pool. The pool's size is
        the reserved memory it added (other threads' allocations in the
        meantime count too)."""
        g = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev):
            stream = _capture_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.graph(g, stream=stream, capture_error_mode="thread_local"):
                before = torch.cuda.memory_reserved(dev)
                out = body()
            torch.cuda.current_stream(dev).wait_stream(stream)
        return g, out, torch.cuda.memory_reserved(dev) - before

    def fence(self, dev: torch.device):
        return _EventFence(dev)


_BACKEND: Any = CudaGraphs()


@contextlib.contextmanager
def use_backend(backend) -> Iterator[None]:
    """Swap the capture backend (tests: a stand-in that handles CPU
    tensors); the previous one comes back on exit. Existing entries stay
    with the backend that captured them."""
    global _BACKEND
    prev, _BACKEND = _BACKEND, backend
    try:
        yield
    finally:
        _BACKEND = prev


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


class _Entry:
    """One captured key: the graph, its static buffers and the lock and
    fence that serialise their use."""

    __slots__ = ("graph", "static_in", "static_out", "out_spec", "fence", "lock",
                 "replays", "pool_bytes", "capture_s", "shape")

    def __init__(self, graph, static_in, static_out, out_spec, fence, pool_bytes,
                 capture_s, shape):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.out_spec, self.fence, self.lock = out_spec, fence, threading.Lock()
        self.replays, self.pool_bytes, self.capture_s = 0, pool_bytes, capture_s
        self.shape = shape

    def replay(self, leaves: List[torch.Tensor]):
        with self.lock, torch.no_grad():
            self.fence.wait()
            for s, x in zip(self.static_in, leaves, strict=True):
                s.copy_(x)
            self.graph.replay()
            outs = [o.clone() for o in self.static_out]
            self.fence.record()
            self.replays += 1
        return _unflatten(self.out_spec, iter(outs))


class _Graphed:
    def __init__(self, family: str, fn: Callable):
        self.fn = fn
        self.name = f"{family}.{fn.__name__}"
        self.lock = threading.Lock()
        self.entries: Dict[tuple, _Entry] = {}

    def eager(self, *args, **kwargs):
        with eager_bodies():
            return self.fn(*args, **kwargs)

    def __call__(self, args: tuple, kwargs: dict):
        if _depth():
            return self.fn(*args, **kwargs)
        key, leaves, spec, dev = call_key(self.name, args, kwargs)
        if dev is None:
            return self.fn(*args, **kwargs)
        with self.lock:
            entry = self.entries.get(key)
        if entry is None:
            return self._miss(key, leaves, spec, dev, args, kwargs)
        return entry.replay(leaves)

    def _miss(self, key, leaves, spec, dev, args, kwargs):
        from ..perf import compile_watch

        with _CAPTURE_LOCK:
            with self.lock:
                entry = self.entries.get(key)
            if entry is not None:  # another thread captured it meanwhile
                return entry.replay(leaves)
            shape = _shape_str(leaves, spec, dev)
            token = compile_watch.begin(self.name, shape)
            t0 = time.perf_counter()
            with torch.inference_mode():
                ref = self.eager(*args, **kwargs)
            with torch.inference_mode(False):
                static_in = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in leaves]
            for s, x in zip(static_in, leaves, strict=True):
                s.copy_(x)
            s_args, s_kwargs = _unflatten(spec, iter(static_in))

            def body():
                with torch.inference_mode():
                    return self.eager(*s_args, **s_kwargs)

            try:
                graph, out, pool = _BACKEND.capture(body, dev)
            except Exception as exc:
                raise RuntimeError(f"graphed {self.name}: capture failed for key "
                                   f"{shape}: {exc!r}") from exc
            out_leaves: list = []
            out_spec = _flatten(out, out_leaves)
            entry = _Entry(graph, static_in, out_leaves, out_spec, _BACKEND.fence(dev),
                           pool, 0.0, shape)
            got = entry.replay(leaves)
            got_leaves: list = []
            ref_leaves: list = []
            if (_flatten(got, got_leaves) != _flatten(ref, ref_leaves)
                    or not all(torch.equal(a, b) for a, b in zip(got_leaves, ref_leaves))):
                raise RuntimeError(f"graphed {self.name}: the first replay differs from "
                                   f"the eager body for key {shape}")
            entry.replays = 0  # the check's replay is part of the capture
            entry.capture_s = time.perf_counter() - t0
            with self.lock:
                self.entries[key] = entry
            compile_watch.finish(token, "miss")
            return got


def graphed(family: str) -> Callable[[Callable], Callable]:
    """Decorator: the function's calls on CUDA run as per-key CUDA graphs
    (module docstring); ``family`` prefixes its ledger and counter name
    (``eddsa`` → ``eddsa.<fn>``). The wrapper keeps the body as
    ``.eager`` and its cache as ``.graphs``."""

    def deco(fn: Callable) -> Callable:
        g = _Graphed(family, fn)
        _REGISTRY.append(g)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            return g(args, kwargs)

        call.eager = g.eager
        call.graphs = g
        return call

    return deco


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


def counts() -> Dict[str, Dict[str, int]]:
    """Per graphed function: ``captures`` (keys captured) and
    ``replays`` (since the capture or :func:`reset_counts`)."""
    out = {}
    for g in _REGISTRY:
        with g.lock:
            ents = list(g.entries.values())
        out[g.name] = {"captures": len(ents), "replays": sum(e.replays for e in ents)}
    return out


def entries() -> List[Dict[str, Any]]:
    """Every captured key: function, key, replays, pool bytes, capture s."""
    rows = []
    for g in _REGISTRY:
        with g.lock:
            ents = list(g.entries.values())
        rows += [{"fn": g.name, "key": e.shape, "replays": e.replays,
                  "pool_bytes": e.pool_bytes, "capture_s": e.capture_s} for e in ents]
    return rows


def snapshot() -> Dict[Tuple[str, str], int]:
    """(function, key) → replays, for telling a runner's hits (keys that
    replayed) from its misses (keys it captured)."""
    return {(r["fn"], r["key"]): r["replays"] for r in entries()}


def clear() -> None:
    """Drop every captured graph and zero the counters (the counterpart
    of ``jax.clear_caches``; the memory pools go with the graphs)."""
    for g in _REGISTRY:
        with g.lock:
            g.entries.clear()


def reset_counts() -> None:
    """Zero the replay counters (captured graphs stay)."""
    for g in _REGISTRY:
        with g.lock:
            for e in g.entries.values():
                e.replays = 0
