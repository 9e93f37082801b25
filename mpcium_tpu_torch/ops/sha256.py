"""Batched SHA-256 on the device — the public surface of
``mpcium_tpu/ops/sha256.py``; the engine lives in :mod:`ops.hash_suite`."""
from __future__ import annotations

from .hash_suite import sha256, sha256_compress, sha256_core  # noqa: F401

__all__ = ["sha256", "sha256_compress", "sha256_core"]
