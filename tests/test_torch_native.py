"""The port's native library (mpcium_tpu_torch/native/) against the JAX
package's (mpcium_tpu/native/), against its own hashlib and numpy
versions (mpcium_tpu_torch/native/plain.py) and against the device
hashes of ops/hash_suite.py on the CPU.

The library is built by g++ at its first call into
``build/mpcium_tpu_torch/``; a missing compiler or a failed build
raises, and nothing falls back.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_golden_writer import ot_host_down  # noqa: F401  (stops ot-host at module end)

from mpcium_tpu_torch import native
from mpcium_tpu_torch.native import plain

ROOT = Path(__file__).resolve().parents[1]


def _rows(seed: int, n: int, width: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, width), dtype=np.uint8)


def test_the_library_builds_from_the_repo_source_into_build():
    lib = native.build()
    assert native.available() and native.build() is lib
    built = sorted((ROOT / "build" / "mpcium_tpu_torch").glob("libbatchhash_*.so"))
    assert built and any(Path(lib._name) == p for p in built)
    assert native.SRC == ROOT / "mpcium_tpu_torch" / "native" / "batch_hash.cpp"


# ---------------------------------------------------------------------------
# hashes: ragged prefixes and widths, below and above the 256-row threading point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [17, 300])
@pytest.mark.parametrize("prefix", [b"", b"tag/", b"mpcium-ot-pad|" + b"x" * 41])
def test_batch_sha256_matches_jax_and_hashlib(prefix, n):
    from mpcium_tpu import native as jnative

    for W in (1, 32, 55, 56, 64, 65, 127, 300):
        rows = _rows(W + n, n, W)
        got = native.batch_sha256(prefix, rows)
        assert got.shape == (n, 32)
        assert np.array_equal(got, plain.batch_sha256(prefix, rows)), W
        assert np.array_equal(got, jnative.batch_sha256(prefix, rows)), W


@pytest.mark.parametrize("n", [9, 260])
@pytest.mark.parametrize("prefix", [b"", b"x", b"p" * 130])
def test_batch_sha512_matches_jax_and_hashlib(prefix, n):
    from mpcium_tpu import native as jnative

    for W in (1, 96, 111, 112, 128, 129, 500):
        rows = _rows(W + n, n, W)
        got = native.batch_sha512(prefix, rows)
        assert got.shape == (n, 64)
        assert np.array_equal(got, plain.batch_sha512(prefix, rows)), W
        assert np.array_equal(got, jnative.batch_sha512(prefix, rows)), W


# ---------------------------------------------------------------------------
# the OT stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 32), (128, 128), (8, 40), (64, 1)])
def test_ot_transpose_matches_jax_and_numpy(shape):
    from mpcium_tpu import native as jnative

    packed = _rows(sum(shape), *shape)
    got = native.ot_transpose(packed)
    assert got.shape == (shape[1] * 8, shape[0] // 8)
    assert np.array_equal(got, plain.ot_transpose(packed))
    assert np.array_equal(got, jnative.ot_transpose(packed))


def test_ot_transpose_refuses_kappa_off_a_byte_like_jax():
    from mpcium_tpu import native as jnative

    bad = np.zeros((12, 8), dtype=np.uint8)
    with pytest.raises(AssertionError, match="kappa=12"):
        jnative.ot_transpose(bad)
    with pytest.raises(ValueError, match="kappa=12"):
        native.ot_transpose(bad)


@pytest.mark.parametrize("blk_off", [0, 7, 1 << 20])
def test_prg_expand_matches_jax_and_the_message_matrix(blk_off):
    from mpcium_tpu import native as jnative

    seeds = _rows(10, 5, 32)
    prefix = b"mpcium-ot-prg|t"
    got = native.prg_expand(prefix, seeds, 3, blk_off=blk_off)
    assert got.shape == (5, 96)
    assert np.array_equal(got, plain.prg_expand(prefix, seeds, 3, blk_off))
    assert np.array_equal(got, jnative.prg_expand(prefix, seeds, 3, blk_off=blk_off))


def test_prg_expand_chunks_concatenate_to_the_full_expansion():
    seeds = _rows(11, 128, 32)
    full = native.prg_expand(b"p", seeds, 8)
    parts = [native.prg_expand(b"p", seeds, 2, blk_off=o) for o in (0, 2, 4, 6)]
    assert np.array_equal(np.concatenate(parts, axis=1), full)


def test_prg_expand_refuses_seeds_of_another_width():
    with pytest.raises(ValueError, match="seeds must be"):
        native.prg_expand(b"p", np.zeros((4, 16), np.uint8), 1)


def test_xor_rows_in_place_and_broadcast():
    a = _rows(12, 6, 40)
    b = _rows(13, 6, 40)
    want = a ^ b
    got = native.xor_rows(a, b)
    assert got is a and np.array_equal(a, want)  # in place, no new array
    row = _rows(14, 1, 40)[0]
    want = a ^ row
    assert native.xor_rows(a, row) is a and np.array_equal(a, want)
    big = _rows(15, 128, 4096)  # > one 64 KiB stripe: the threaded path
    other = _rows(16, 128, 4096)
    want = plain.xor_rows(big.copy(), other)
    assert np.array_equal(native.xor_rows(big, other), want)


def test_xor_rows_takes_numpy_for_a_strided_destination():
    base = _rows(17, 8, 64)
    view = base[:, ::2]  # not contiguous: the library cannot write through it
    src = _rows(18, 8, 32)
    want = view ^ src
    assert native.xor_rows(view, src) is view
    assert np.array_equal(base[:, ::2], want)


def test_native_threads_are_scheduling_only(monkeypatch):
    rows = _rows(13, 700, 64)
    packed = _rows(14, 128, 128)
    seeds = _rows(15, 128, 32)
    big = _rows(16, 128, 8192)
    src = _rows(17, 128, 8192)
    outs = {}
    for n in ("1", "4"):
        monkeypatch.setenv("MPCIUM_NATIVE_THREADS", n)
        assert native.threads() == int(n)
        outs[n] = (native.batch_sha256(b"t", rows), native.batch_sha512(b"t", rows),
                   native.ot_transpose(packed), native.prg_expand(b"t", seeds, 4),
                   native.xor_rows(big.copy(), src))
    for x, y in zip(outs["1"], outs["4"]):
        assert np.array_equal(x, y)
    monkeypatch.delenv("MPCIUM_NATIVE_THREADS")
    assert native.threads() >= 1


# ---------------------------------------------------------------------------
# each host stage equals its device counterpart (ops/hash_suite.py)
# ---------------------------------------------------------------------------


def test_prg_expand_equals_the_device_prg():
    from mpcium_tpu_torch.ops import hash_suite as hs

    seeds = _rows(20, 128, 32)
    prefix = b"mpcium-ot-prg|node0->node1|v3|0"
    got = native.prg_expand(prefix, seeds, 8, blk_off=24)
    want = hs.prg_expand_core(torch.as_tensor(seeds), hs.as_bytes(prefix), 8, 24)
    assert np.array_equal(got, want.numpy())


def test_ot_transpose_equals_the_device_transpose():
    from mpcium_tpu_torch.ops import hash_suite as hs

    packed = _rows(21, 128, 8 * 32)
    want = hs.ot_transpose_core(torch.as_tensor(packed))
    assert np.array_equal(native.ot_transpose(packed), want.numpy())


@pytest.mark.parametrize("m_off", [0, 1 << 16])
def test_pad_hashing_equals_the_device_pad_hash(m_off):
    from mpcium_tpu_torch.ops import hash_suite as hs
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot

    packed = _rows(22, 128, 64)
    M = packed.shape[1] * 8
    prefixes = mta_ot.OTMtALeg._pad_prefixes(b"node0->node1|v3|0", 2)
    delta = _rows(23, 1, 16)[0]
    pads = mta_ot._derive_pads_multi(prefixes, packed, M, delta=delta, m_off=m_off)
    rows = hs.ot_transpose_core(torch.as_tensor(packed))
    idx = hs.le32_bytes(m_off + torch.arange(M, dtype=torch.int64))
    for prefix, (pad0, pad1) in zip(prefixes, pads):
        p = hs.as_bytes(prefix)
        assert np.array_equal(pad0, hs.pad_hash_core(p, rows, idx).numpy())
        assert np.array_equal(
            pad1, hs.pad_hash_core(p, rows ^ torch.as_tensor(delta)[None, :], idx).numpy()
        )


# ---------------------------------------------------------------------------
# no toolchain, a broken source, concurrent builds
# ---------------------------------------------------------------------------


@pytest.fixture
def unbuilt(monkeypatch, tmp_path):
    """The loader as a fresh process sees it, building into ``tmp_path``."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    return tmp_path


def test_a_missing_compiler_raises_and_nothing_falls_back(monkeypatch, unbuilt):
    from mpcium_tpu_torch.protocol.ecdsa import mta_ot
    from mpcium_tpu_torch.utils import ot_golden as og

    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    rows = _rows(30, 4, 8)
    calls = [
        lambda: native.batch_sha256(b"", rows),
        lambda: native.batch_sha512(b"", rows),
        lambda: native.ot_transpose(np.zeros((8, 4), np.uint8)),
        lambda: native.prg_expand(b"", np.zeros((2, 32), np.uint8), 1),
        lambda: native.xor_rows(rows, rows.copy()),
        native.threads,
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            call()
    assert not native.available()
    # the host OT route reaches the library and raises with it
    monkeypatch.setenv("MPCIUM_OT_DEVICE", "0")
    tag, k0, k1, delta = og.synth_base_ot()
    leg = mta_ot.OTMtALeg.from_base_ot(tag, k0, k1, delta, device="cpu")
    a, g, _w = og.leg_inputs(2)
    from mpcium_tpu_torch.core import bignum as bn

    limbs = [torch.as_tensor(bn.batch_to_limbs(v, bn.P256)) for v in (a, g)]
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        leg.run_multi(limbs[0], (limbs[1],))
    assert not list(unbuilt.iterdir())


def test_a_failed_build_raises_with_the_compiler_log(monkeypatch, unbuilt):
    bad = unbuilt / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp") as exc:
        native.batch_sha256(b"", _rows(31, 2, 4))
    assert "error" in str(exc.value)
    assert not list(unbuilt.glob("*.so"))


def test_concurrent_processes_build_one_library(tmp_path):
    """Three processes build into one empty directory at once (xdist
    workers, chip_smoke.py's children): each loads a whole library and
    the directory ends with one .so and no temporary file."""
    code = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from mpcium_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "out = native.batch_sha256(b'x', np.zeros((3, 5), np.uint8))\n"
        "print(out[0].tobytes().hex())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [e for _o, e in outs]
    want = plain.batch_sha256(b"x", np.zeros((1, 5), np.uint8))[0].tobytes().hex()
    assert {o.strip() for o, _e in outs} == {want}
    assert [p.name for p in tmp_path.iterdir()] == [
        f"libbatchhash_{_digest()}.so"
    ]


def _digest() -> str:
    import hashlib

    flags = native.CXX_FLAGS + native.LIBS
    return hashlib.sha256(native.SRC.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
