"""The port's per-shape CUDA graphs (engine/graphs.py) and the EdDSA
engine's graphed functions, on the CPU.

On CPU tensors a graphed function runs its body. The key, buffer, lock
and replay logic is driven through a stand-in capture backend that
handles CPU tensors: its "capture" runs the body once on the static
inputs, and its "replay" runs the body again and copies the result into
the static outputs. Each graphed EdDSA function, replayed that way at
B=2, equals the JAX package's jitted function byte for byte: the
committed golden ``graphs_b2.json`` was written by the JAX functions on
the same seeded inputs (the live JAX run, which also shows the golden is
current, is slow-tier: its CPU compiles take minutes). Rewrite it::

    JAX_PLATFORMS=cpu python tests/test_torch_graphs.py --write-golden
"""
import json
import os
import sys
import threading
from pathlib import Path
from typing import NamedTuple

if __name__ == "__main__":  # as a script: the repo root on the path, JAX on the CPU
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
from torch_golden_writer import pipe_host_down  # noqa: F401  (stops pipe-host at module end)
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpcium_tpu_torch.core import bignum as bn
from mpcium_tpu_torch.core import ed25519 as ed
from mpcium_tpu_torch.core import hostmath as hm
from mpcium_tpu_torch.core import secp256k1 as sp
from mpcium_tpu_torch.engine import eddsa_batch as eb
from mpcium_tpu_torch.engine import graphs
from mpcium_tpu_torch.ops import hash_suite as hs
from mpcium_tpu_torch.perf import compile_watch
from mpcium_tpu_torch.utils import eddsa_golden as eg
from mpcium_tpu_torch.utils import graphs_golden as gg
from mpcium_tpu_torch.utils.rng import SeededStream

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parents[1] / "mpcium_tpu_torch" / "data" / "goldens" / \
    "graphs_b2.json"
PORT_FNS = {**{n: getattr(eb, n) for n in gg.FUNCTIONS if n != "sha512"}, "sha512": eb._sha512}


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


class _Rerun:
    """A stand-in graph: replay runs the body on the static inputs and
    copies its outputs into the static ones."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        new, old = [], []
        graphs._flatten(self.body(), new)
        graphs._flatten(self.out, old)
        with torch.inference_mode():
            for o, n in zip(old, new, strict=True):
                o.copy_(n)


class _NoFence:
    def wait(self):
        pass

    def record(self):
        pass


class StandIn:
    """A capture backend for CPU tensors (every device, with ``every``)."""

    def __init__(self, every: bool = False):
        self.every, self.captured = every, 0

    def handles(self, dev):
        return self.every or dev.type == "cpu"

    def capture(self, body, dev):
        self.captured += 1
        out = body()
        return _Rerun(body, out), out, 0

    def fence(self, dev):
        return _NoFence()


@pytest.fixture(autouse=True)
def fresh_graphs():
    graphs.clear()
    compile_watch.reset()
    yield
    graphs.clear()
    compile_watch.reset()


@graphs.graphed("test")
def _axpy(x, y, scale=3):
    return x * scale + y, {"diff": (x - y).sum(-1)}


# ---------------------------------------------------------------------------
# the CPU path and the key
# ---------------------------------------------------------------------------


def test_cpu_tensors_run_the_body_and_count_nothing():
    (r64, *_), = (args for name, args in gg.calls() if name == "nonce_commitments")
    got = eb.nonce_commitments(_t(r64))
    want = eb.nonce_commitments.eager(_t(r64))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(c == {"captures": 0, "replays": 0} for c in graphs.counts().values())
    assert graphs.entries() == [] and compile_watch.entries() == []


def test_keys_differ_by_shape_dtype_device_and_non_tensor_argument():
    x = torch.zeros(2, 3, dtype=torch.int32)
    with graphs.use_backend(StandIn(every=True)):
        k = graphs.call_key("f", (x,), {})[0]
        assert graphs.call_key("f", (torch.ones(2, 3, dtype=torch.int32),), {})[0] == k
        others = [graphs.call_key("f", (torch.zeros(3, 2, dtype=torch.int32),), {})[0],
                  graphs.call_key("f", (x.to(torch.int64),), {})[0],
                  graphs.call_key("f", (x.to("meta"),), {})[0],
                  graphs.call_key("f", (x,), {"scale": 2})[0],
                  graphs.call_key("f", (x, 2), {})[0],
                  graphs.call_key("f", ({"a": x},), {})[0],
                  graphs.call_key("g", (x,), {})[0]]
    assert len({k, *others}) == 1 + len(others)
    # without a backend that takes the device there is no key to replay
    assert graphs.call_key("f", (x,), {})[3] is None


class _PairA(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor


class _PairB(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor


@graphs.graphed("test")
def _point_step(p, k=2):
    return sp.SecpPointJ(p.X + p.Y, p.Y, p.Z * k), p.X.sum(-1)


def _specs_with(spec, tag: str) -> bool:
    if spec[0] == tag:
        return True
    kids = {"D": 2, "NT": 2, "tuple": 1, "list": 1}.get(spec[0])
    return kids is not None and any(_specs_with(c, tag) for c in spec[kids])


def test_a_namedtuple_is_part_of_the_key_and_comes_back_as_its_type():
    x = torch.zeros(2, 3, dtype=torch.int32)
    with graphs.use_backend(StandIn(every=True)):
        keys = {graphs.call_key("f", (_PairA(x, x),), {})[0],
                graphs.call_key("f", (_PairB(x, x),), {})[0],
                graphs.call_key("f", ((x, x),), {})[0]}
        spec = graphs.call_key("f", (_PairA(x, x),), {})[2]
    assert len(keys) == 3
    assert type(graphs._unflatten(spec, iter([x, x + 1]))[0][0]) is _PairA
    pt = sp.SecpPointJ(*(torch.arange(6, dtype=torch.float64).reshape(2, 3) + i
                         for i in range(3)))
    pt2 = sp.SecpPointJ(*(c * 3 for c in pt))
    with graphs.use_backend(StandIn()):
        first, second = _point_step(pt), _point_step(pt2)
    for got, p in ((first, pt), (second, pt2)):
        want = _point_step.eager(p)
        assert type(got[0]) is sp.SecpPointJ
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert torch.equal(got[1], want[1])
    assert graphs.counts()["test._point_step"] == {"captures": 1, "replays": 1}


def test_the_eddsa_keys_hold_no_namedtuple():
    """The EdDSA functions take tensors, tuples and dicts: their keys are
    what they were before NamedTuples joined the spec."""
    with graphs.use_backend(StandIn(every=True)):
        for name, args in gg.calls():
            spec = graphs.call_key(name, gg.to_args(args, _t), {})[2]
            assert not _specs_with(spec, "NT"), name
        parts, R = gg.to_args(dict(gg.calls())["combine_signatures"], _t)
        key = graphs.call_key("eddsa.combine_signatures", (parts, R), {})[0]
    assert key == ("eddsa.combine_signatures",
                   ("tuple", (("tuple", (("T",), ("T",))), ("D", (), ()))),
                   ((tuple(parts.shape), parts.dtype), (tuple(R.shape), R.dtype)), "cpu")


def test_a_miss_captures_once_then_replays_contiguous_buffers_and_fresh_outputs():
    x = torch.arange(8, dtype=torch.int64).reshape(1, 8)
    y = torch.arange(16, dtype=torch.int64).reshape(2, 8)
    backend = StandIn()
    with graphs.use_backend(backend):
        first = _axpy(x.expand(2, 8), y)
        second = _axpy(x.expand(2, 8) + 1, y)
        (entry,) = _axpy.graphs.entries.values()
    assert backend.captured == 1
    assert torch.equal(first[0], x * 3 + y) and torch.equal(second[0], (x + 1) * 3 + y)
    assert torch.equal(second[1]["diff"], (x + 1 - y).sum(-1))
    assert all(s.is_contiguous() and s.shape == (2, 8) for s in entry.static_in)
    ptrs = {t.data_ptr() for t in entry.static_in + entry.static_out}
    assert not ptrs & {first[0].data_ptr(), second[0].data_ptr(), second[1]["diff"].data_ptr()}
    assert graphs.counts()["test._axpy"] == {"captures": 1, "replays": 1}
    (led,) = compile_watch.entries()
    assert led["engine"] == "test._axpy" and led["cache"] == "miss"
    assert led["shape"] == "int64[2, 8],int64[2, 8]@cpu"


def test_four_threads_replaying_one_key_each_get_the_eager_result():
    with graphs.use_backend(StandIn()):
        _axpy(torch.zeros(4, 16, dtype=torch.int64), torch.zeros(4, 16, dtype=torch.int64))
        errors, old = [], sys.getswitchinterval()

        def worker(i: int) -> None:
            g = torch.Generator().manual_seed(i)
            for _ in range(50):
                x, y = (torch.randint(0, 1000, (4, 16), generator=g) for _ in range(2))
                got = _axpy(x, y)
                if not (torch.equal(got[0], x * 3 + y)
                        and torch.equal(got[1]["diff"], (x - y).sum(-1))):
                    errors.append(i)

        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert graphs.counts()["test._axpy"] == {"captures": 1, "replays": 200}


def test_a_capture_that_fails_names_the_function_and_the_key():
    class Broken(StandIn):
        def capture(self, body, dev):
            raise ValueError("operation not permitted when stream is capturing")

    with graphs.use_backend(Broken()), pytest.raises(RuntimeError, match=r"test\._axpy.*int64"):
        _axpy(torch.zeros(2, 2, dtype=torch.int64), torch.zeros(2, 2, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the EdDSA functions: capture safety, caches, JAX
# ---------------------------------------------------------------------------


class _Syncs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._local_scalar_dense.default:
            self.bad.append(str(func))
        if func is torch.ops.aten.lift_fresh.default and out.numel() > 1:
            self.bad.append(f"{func} of {tuple(out.shape)}")  # data from the host
        return out


def test_second_calls_make_no_host_sync_and_no_upload(monkeypatch):
    """What a capture forbids: a scalar read back (``.item()``, ``bool``)
    and a tensor built from host data, on the second call of each
    function (the first fills the constant caches)."""
    made = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def spy(data, *a, _real=real, **k):
            if not isinstance(data, torch.Tensor):
                made.append(type(data).__name__)
            return _real(data, *a, **k)

        monkeypatch.setattr(torch, name, spy)
    for name, args in gg.calls():
        args = gg.to_args(args, _t)
        PORT_FNS[name](*args)
        made.clear()
        mode = _Syncs()
        with mode:
            PORT_FNS[name](*args)
        assert mode.bad == [] and made == [], name


def test_constant_caches_are_one_tensor_per_value_and_survive_a_party_sign():
    from mpcium_tpu_torch.protocol.eddsa.batch_signing import BatchedEDDSASigningParty
    from mpcium_tpu_torch.protocol.runner import run_protocol

    cpu = torch.device("cpu")
    F = ed.ed25519_field(cpu)
    L = ed.scalar_ring(cpu)
    consts = {"d": F.const(hm.ED_D), "one": F.const(1, (3,)), "l": bn.const_limbs(hm.ED_L,
              bn.P256, cpu), "two": L.const(2, (2,)), "shifts": hs._be32_shifts(cpu),
              "tail": hs._md_tail(96, 128, 16, cpu)}
    assert bn.const_limbs(hm.ED_L, bn.P256, cpu) is consts["l"]
    assert F.const(1).data_ptr() == consts["one"].data_ptr()
    assert hs._be32_shifts(cpu) is consts["shifts"]
    assert hs._md_tail(96, 128, 16, cpu) is consts["tail"]
    want = {k: v.clone() for k, v in consts.items()}
    shares = eb.dealer_keygen_batch(2, eg.UNIVERSE, eg.THRESHOLD, rng=SeededStream(31))
    msgs = eg.messages(2, 9)
    parties = {pid: BatchedEDDSASigningParty("graphs-consts", pid, eg.QUORUM,
                                             shares[eg.UNIVERSE.index(pid)], msgs,
                                             rng=SeededStream(32 + i), device="cpu")
               for i, pid in enumerate(eg.QUORUM)}
    run_protocol(parties)
    for pid, p in parties.items():
        assert p.result["ok"].all(), pid
        for w in range(2):
            assert hm.ed25519_verify(shares[0][w].public_key, msgs[w],
                                     bytes(p.result["signatures"][w]))
    assert all(torch.equal(consts[k], want[k]) for k in consts)
    assert bn.from_limbs(consts["l"].numpy(), bn.P256) == hm.ED_L
    assert bn.from_limbs(F.canonical(consts["d"]).numpy(), bn.P256) == hm.ED_D


def test_each_graphed_function_replayed_equals_the_jax_golden():
    """Every function at B=2 through a stand-in capture: the miss holds
    its first replay to the eager body, the hit replays again; both equal
    the JAX package's jitted outputs byte for byte, as the plain body
    does."""
    want = json.loads(GOLDEN.read_text())["record"]
    assert sorted(want) == sorted(gg.FUNCTIONS)
    assert gg.record(PORT_FNS, _t) == want
    with graphs.use_backend(StandIn()):
        assert gg.record(PORT_FNS, _t) == want  # misses: captured
        assert gg.record(PORT_FNS, _t) == want  # hits: replayed
    counts = graphs.counts()
    for name in gg.FUNCTIONS:
        assert counts[f"eddsa.{name}"] == {"captures": 1, "replays": 1}, name


@pytest.mark.slow
def test_live_jax_functions_match_the_golden():
    assert _jax_record() == json.loads(GOLDEN.read_text())["record"]


def _jax_record() -> dict:
    import jax.numpy as jnp

    from mpcium_tpu.engine import eddsa_batch as jeb
    from mpcium_tpu.ops import hash_suite as jhs

    fns = {**{n: getattr(jeb, n) for n in gg.FUNCTIONS if n != "sha512"}, "sha512": jhs.sha512}
    return gg.record(fns, lambda a: jnp.asarray(np.array(a)))


def write_golden() -> None:
    GOLDEN.write_text(json.dumps({
        "about": "Outputs of the JAX package's jitted EdDSA engine functions and "
                 "hash_suite.sha512 at B=2, q=2 on the CPU (tests/test_torch_graphs.py "
                 "--write-golden); inputs in mpcium_tpu_torch/utils/graphs_golden.py",
        "B": gg.B, "q": gg.Q, "seed": gg.SEED,
        "record": _jax_record(),
    }, indent=1) + "\n")
    print("graphs golden written", flush=True)


if __name__ == "__main__" and "--write-golden" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_golden()
