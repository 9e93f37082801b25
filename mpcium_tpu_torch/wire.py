"""Canonical JSON (the port's copy of ``canonical_json`` from the JAX
package's ``wire.py``; the envelopes and commands come with the serving
slice).

The bytes are a wire constant: the batched ECDSA party hashes the
quorum's Paillier/ring-Pedersen material through this function, and a
GPU node and a TPU node of one committee must derive the same digest.
"""
from __future__ import annotations

import json
from typing import Any


def canonical_json(obj: Any) -> bytes:
    """Deterministic JSON: sorted keys, no whitespace, UTF-8."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
