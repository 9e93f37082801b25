"""Environment fingerprints: which machine and toolchain produced a number.

The port's counterpart of the JAX package's ``perf/envfp.py``, with its
function names and keys: a soak report stamps ``env_fingerprint()`` so a
record says where it was measured. Where the JAX copy reads jax, this one
reads torch: ``torch`` (the version), ``cuda`` (the toolkit torch was
built with) and the device facts of an already-imported torch —
``platform`` ("gpu" when a CUDA device is present, else "cpu"),
``device_kind`` (``torch.cuda.get_device_name(0)``) and ``device_count``.
``host_fingerprint`` and ``git_sha`` are the JAX package's.

Import-light like the JAX copy: torch is read from ``sys.modules`` and
never imported here, so stamping a record costs no backend bring-up.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from typing import Dict, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))

# the env knobs that change what a perf number means; anything else
# (paths, passwords) is noise the fingerprint must not leak
_KNOB_PREFIXES = (
    "MPCIUM_MTA", "MPCIUM_OT_", "MPCIUM_PIPELINE_COHORTS",
    "MPCIUM_BATCH_VERIFY", "MPCIUM_EDDSA_DEVICE_HASH",
    "MPCIUM_PAILLIER_RAND_BITS", "MPCIUM_PROFILE", "CUDA_VISIBLE_DEVICES",
)


def host_fingerprint() -> str:
    """Short stable id for THIS host's CPU feature set."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha256(
                        " ".join(sorted(line.split()[2:])).encode()
                    ).hexdigest()[:12]
    except OSError:
        pass
    import platform as _p

    return hashlib.sha256(_p.processor().encode() or b"?").hexdigest()[:12]


def git_sha() -> Optional[str]:
    try:
        r = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=_REPO, capture_output=True, timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        return None
    return r.stdout.decode().strip() or None


def torch_version() -> Optional[str]:
    torch = sys.modules.get("torch")
    if torch is not None:
        return getattr(torch, "__version__", None)
    try:
        from importlib.metadata import version

        return version("torch")
    except Exception:  # noqa: BLE001 — fingerprinting must never raise
        return None


def cuda_version() -> Optional[str]:
    """The CUDA toolkit an already-imported torch was built with (None
    for a CPU build, or when torch is not imported)."""
    return getattr(getattr(sys.modules.get("torch"), "version", None), "cuda", None)


def device_facts() -> Dict[str, object]:
    """platform/kind/count of an ALREADY-imported torch, or
    ``{"platform": "uninitialized"}``; never imports torch."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {"platform": "uninitialized"}
    try:
        if not torch.cuda.is_available():
            return {"platform": "cpu", "device_kind": "cpu",
                    "device_count": 1}
        return {
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
        }
    except Exception:  # noqa: BLE001 — a wedged driver is a fact too
        return {"platform": "unavailable"}


def knob_snapshot() -> Dict[str, str]:
    return {
        k: v for k, v in sorted(os.environ.items())
        if k.startswith(_KNOB_PREFIXES)
    }


def env_fingerprint() -> Dict[str, object]:
    """The full stamp a soak record carries. Values are public build and
    machine facts only."""
    fp: Dict[str, object] = {
        "git_sha": git_sha(),
        "torch": torch_version(),
        "cuda": cuda_version(),
        "python": ".".join(map(str, sys.version_info[:3])),
        "host": host_fingerprint(),
        "knobs": knob_snapshot(),
    }
    fp.update(device_facts())
    return fp
