"""A seeded, reproducible random stream with the ``secrets`` surface.

The engines draw every secret through ``rng.token_bytes``,
``rng.randbelow`` and ``rng.randbits`` (the ``secrets`` module in
production). Two engines that make the same calls in the same order on
two instances of :class:`SeededStream` with one seed see the same bytes,
so their signatures can be compared byte for byte. For tests and
benchmarks only: a seed is not a secret.
"""
from __future__ import annotations

import hashlib

_DOMAIN = b"mpcium-tpu-torch/seeded-stream/v1"


class SeededStream:
    """SHAKE-256 keyed by the seed, one independent output per call."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._key = hashlib.sha256(
            _DOMAIN + self.seed.to_bytes(16, "little", signed=True)
        ).digest()
        self._ctr = 0

    def token_bytes(self, n: int) -> bytes:
        h = hashlib.shake_256(self._key + self._ctr.to_bytes(8, "little"))
        self._ctr += 1
        return h.digest(n) if n else b""

    def randbits(self, k: int) -> int:
        if k <= 0:
            return 0
        v = int.from_bytes(self.token_bytes(-(-k // 8)), "little")
        return v & ((1 << k) - 1)

    def randbelow(self, n: int) -> int:
        if n <= 0:
            raise ValueError("randbelow needs n > 0")
        k = n.bit_length()
        while True:
            v = self.randbits(k)
            if v < n:
                return v


class DetRng:
    """The JAX package's test stream for OT legs (``tests/test_tamper_checks.py``):
    SHA-256 of ``advrng|seed|ctr`` blocks; ``randbelow`` reduces 40 bytes.
    Synthetic base-OT keys and payload randomness for leg goldens."""

    def __init__(self, seed: int):
        self.seed = seed
        self.ctr = 0

    def token_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += hashlib.sha256(b"advrng|%d|%d" % (self.seed, self.ctr)).digest()
            self.ctr += 1
        return bytes(out[:n])

    def randbelow(self, n: int) -> int:
        return int.from_bytes(self.token_bytes(40), "big") % n
