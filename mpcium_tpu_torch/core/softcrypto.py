"""Pure-Python stand-ins for the `cryptography` package (the port's copy
of the JAX package's ``core/softcrypto.py``, as far as ``identity``,
``store/kvstore`` and the broker channel ``transport/secure`` call it).

The control-plane crypto (envelope authentication, share-store sealing,
the broker channel) rides OpenSSL through `cryptography` where that wheel
is installed; where it is not, this module implements the API subset the
port uses, from the public specs:

- Ed25519 sign/verify (RFC 8032), over :mod:`.hostmath`;
- ChaCha20-Poly1305 AEAD (RFC 8439);
- X25519 (RFC 7748);
- HKDF-SHA256 (RFC 5869);
- the `serialization` surface identity.py touches (Raw encodings).

Class and exception names mirror `cryptography`, so call sites do
``try: from cryptography... except ImportError: from ..core.softcrypto
import ...`` and run unchanged. Both give the same bytes: Ed25519 is
deterministic, the AEAD and HKDF are fixed constructions, and X25519 is a
function of its two inputs. Throughput is pure Python (MB/s, not GB/s):
fine for envelopes, key files and broker frames, and a floor under
serving that the cluster's timings report per stage.
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import secrets
import struct
from typing import Optional

from . import hostmath as _hm

HAVE_OPENSSL = False  # marker: this is the fallback implementation


class InvalidSignature(Exception):
    """cryptography.exceptions.InvalidSignature equivalent."""


class InvalidTag(Exception):
    """cryptography.exceptions.InvalidTag equivalent (AEAD auth failure)."""


# ---------------------------------------------------------------------------
# serialization shim (identity.py only ever uses Raw/Raw/NoEncryption)
# ---------------------------------------------------------------------------


class _Sentinel:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self):  # pragma: no cover - debugging nicety
        return f"<softcrypto.{self.name}>"

    def __call__(self):
        return self


class serialization:  # noqa: N801 — mirrors the cryptography module name
    class Encoding:
        Raw = _Sentinel("Encoding.Raw")

    class PrivateFormat:
        Raw = _Sentinel("PrivateFormat.Raw")

    class PublicFormat:
        Raw = _Sentinel("PublicFormat.Raw")

    class NoEncryption:
        def __init__(self):
            pass


# ---------------------------------------------------------------------------
# Ed25519 (RFC 8032) over hostmath's from-scratch curve ops
# ---------------------------------------------------------------------------


class Ed25519PublicKey:
    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("Ed25519 public key must be 32 bytes")
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "Ed25519PublicKey":
        return cls(data)

    def public_bytes(self, encoding=None, format=None) -> bytes:  # noqa: A002
        return self._raw

    def public_bytes_raw(self) -> bytes:
        return self._raw

    def verify(self, signature: bytes, data: bytes) -> None:
        if not _hm.ed25519_verify(self._raw, data, signature):
            raise InvalidSignature("ed25519 signature mismatch")


class Ed25519PrivateKey:
    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("Ed25519 private key must be 32 bytes")
        self._seed = bytes(seed)
        self._pub = _hm.ed25519_public_from_seed(self._seed)

    @classmethod
    def generate(cls) -> "Ed25519PrivateKey":
        return cls(secrets.token_bytes(32))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "Ed25519PrivateKey":
        return cls(data)

    def private_bytes(self, encoding=None, format=None, encryption_algorithm=None) -> bytes:  # noqa: A002,E501
        return self._seed

    def private_bytes_raw(self) -> bytes:
        return self._seed

    def sign(self, data: bytes) -> bytes:
        return _hm.ed25519_sign_plain(self._seed, data)

    def public_key(self) -> Ed25519PublicKey:
        return Ed25519PublicKey(self._pub)


# ---------------------------------------------------------------------------
# ChaCha20-Poly1305 AEAD (RFC 8439)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK32


def _chacha20_block(key_words, counter: int, nonce_words) -> bytes:
    x = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & _MASK32, *nonce_words,
    ]
    s = list(x)
    for _ in range(10):  # 20 rounds = 10 column+diagonal double rounds
        for a, b, c, d in (
            (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
            (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
        ):
            s[a] = (s[a] + s[b]) & _MASK32
            s[d] = _rotl32(s[d] ^ s[a], 16)
            s[c] = (s[c] + s[d]) & _MASK32
            s[b] = _rotl32(s[b] ^ s[c], 12)
            s[a] = (s[a] + s[b]) & _MASK32
            s[d] = _rotl32(s[d] ^ s[a], 8)
            s[c] = (s[c] + s[d]) & _MASK32
            s[b] = _rotl32(s[b] ^ s[c], 7)
    return struct.pack("<16I", *((s[i] + x[i]) & _MASK32 for i in range(16)))


def _chacha20_xor(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    key_words = struct.unpack("<8I", key)
    nonce_words = struct.unpack("<3I", nonce)
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        block = _chacha20_block(key_words, counter + i // 64, nonce_words)
        chunk = data[i:i + 64]
        out[i:i + len(chunk)] = bytes(
            a ^ b for a, b in zip(chunk, block)
        )
    return bytes(out)


_P1305 = (1 << 130) - 5


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i:i + 16]
        n = int.from_bytes(chunk, "little") + (1 << (8 * len(chunk)))
        acc = ((acc + n) * r) % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    rem = len(data) % 16
    return b"\x00" * (16 - rem) if rem else b""


class ChaCha20Poly1305:
    """RFC 8439 AEAD construction; API-compatible with
    cryptography.hazmat.primitives.ciphers.aead.ChaCha20Poly1305."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        otk = _chacha20_block(
            struct.unpack("<8I", self._key), 0, struct.unpack("<3I", nonce)
        )[:32]
        mac_data = (
            aad + _pad16(aad) + ct + _pad16(ct)
            + struct.pack("<QQ", len(aad), len(ct))
        )
        return _poly1305(otk, mac_data)

    def encrypt(self, nonce: bytes, data: bytes, associated_data: Optional[bytes]) -> bytes:  # noqa: E501
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        aad = associated_data or b""
        ct = _chacha20_xor(self._key, 1, nonce, data)
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes, associated_data: Optional[bytes]) -> bytes:  # noqa: E501
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than the Poly1305 tag")
        aad = associated_data or b""
        ct, tag = data[:-16], data[-16:]
        if not _hmac.compare_digest(self._tag(nonce, ct, aad), tag):
            raise InvalidTag("AEAD authentication failed")
        return _chacha20_xor(self._key, 1, nonce, ct)


# ---------------------------------------------------------------------------
# X25519 (RFC 7748)
# ---------------------------------------------------------------------------

_X25519_P = 2**255 - 19
_X25519_A24 = 121665


def _x25519_scalarmult(k: bytes, u: bytes) -> bytes:
    # decodeScalar25519 + decodeUCoordinate (RFC 7748 §5)
    ki = int.from_bytes(k, "little")
    ki &= ~(7) & ((1 << 256) - 1)
    ki &= (1 << 254) - 1
    ki |= 1 << 254
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    p = _X25519_P
    for t in range(254, -1, -1):
        k_t = (ki >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        A = (x2 + z2) % p
        AA = A * A % p
        B = (x2 - z2) % p
        BB = B * B % p
        E = (AA - BB) % p
        C = (x3 + z3) % p
        D = (x3 - z3) % p
        DA = D * A % p
        CB = C * B % p
        x3 = (DA + CB) % p
        x3 = x3 * x3 % p
        z3 = (DA - CB) % p
        z3 = x1 * (z3 * z3 % p) % p
        x2 = AA * BB % p
        z2 = E * (AA + _X25519_A24 * E) % p
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, p - 2, p) % p).to_bytes(32, "little")


_X25519_BASE = (9).to_bytes(32, "little")


class X25519PublicKey:
    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("X25519 public key must be 32 bytes")
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "X25519PublicKey":
        return cls(data)

    def public_bytes_raw(self) -> bytes:
        return self._raw

    def public_bytes(self, encoding=None, format=None) -> bytes:  # noqa: A002
        return self._raw


class X25519PrivateKey:
    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("X25519 private key must be 32 bytes")
        self._raw = bytes(raw)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(secrets.token_bytes(32))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "X25519PrivateKey":
        return cls(data)

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(_x25519_scalarmult(self._raw, _X25519_BASE))

    def exchange(self, peer_public_key: X25519PublicKey) -> bytes:
        ss = _x25519_scalarmult(self._raw, peer_public_key.public_bytes_raw())
        if ss == b"\x00" * 32:
            # RFC 7748 §6.1: all-zero output means a low-order point
            raise ValueError("X25519 exchange produced the all-zero value")
        return ss


# ---------------------------------------------------------------------------
# HKDF-SHA256 (RFC 5869) — only the (salt, info, length).derive(ikm) shape
# the broker channel uses
# ---------------------------------------------------------------------------


class SHA256:
    """Algorithm marker matching cryptography's hashes.SHA256."""

    digest_size = 32
    name = "sha256"


class HKDF:
    def __init__(self, algorithm=None, length: int = 32,
                 salt: Optional[bytes] = None, info: Optional[bytes] = None):
        if length > 255 * 32:
            raise ValueError("HKDF-SHA256 output too long")
        self._length = length
        self._salt = salt or b"\x00" * 32
        self._info = info or b""

    def derive(self, key_material: bytes) -> bytes:
        prk = _hmac.new(self._salt, key_material, hashlib.sha256).digest()
        okm = b""
        t = b""
        i = 1
        while len(okm) < self._length:
            t = _hmac.new(
                prk, t + self._info + bytes([i]), hashlib.sha256
            ).digest()
            okm += t
            i += 1
        return okm[: self._length]
