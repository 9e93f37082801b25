"""AEAD channel for the TCP bus: X25519 + PSK-bound HKDF + ChaCha20-Poly1305.

The reference's production posture is TLS to NATS with credentials
(main.go:346-359, config.prod.yaml.template). The equivalent here is an
encrypted, token-authenticated channel with no certificate infrastructure:

1. Both ends exchange fresh ephemeral X25519 public keys (one plaintext
   line each way).
2. Directional keys derive via HKDF-SHA256 from the ECDH shared secret,
   salted with both ephemerals, with SHA-256(auth token) mixed into the
   info string. An active man-in-the-middle can relay the ECDH but —
   without the token — cannot derive either key, so it can neither read
   nor forge: confidentiality AND mutual authentication rest on the
   shared token plus fresh ephemerals (forward secrecy per connection).
3. Every subsequent newline frame is ChaCha20-Poly1305 with a per-
   direction counter nonce (replay/reorder within a connection fails
   authentication), hex-encoded to stay line-framed.

Message *integrity at the application layer* additionally never depends
on the channel: protocol envelopes are Ed25519-signed end-to-end
(SECURITY.md "Transport").
"""
from __future__ import annotations

import hashlib
from typing import Tuple

try:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.hashes import SHA256
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
except ImportError:  # bare env: RFC-vector-validated pure-python fallback
    from ..core.softcrypto import (
        HKDF,
        SHA256,
        ChaCha20Poly1305,
        X25519PrivateKey,
        X25519PublicKey,
    )


class ChannelCipher:
    """One direction pair of AEAD states with counter nonces."""

    def __init__(self, send_key: bytes, recv_key: bytes):
        self._send = ChaCha20Poly1305(send_key)
        self._recv = ChaCha20Poly1305(recv_key)
        self._send_ctr = 0
        self._recv_ctr = 0

    def encrypt(self, plaintext: bytes) -> bytes:
        nonce = self._send_ctr.to_bytes(12, "little")
        self._send_ctr += 1
        return self._send.encrypt(nonce, plaintext, None)

    def decrypt(self, ciphertext: bytes) -> bytes:
        nonce = self._recv_ctr.to_bytes(12, "little")
        self._recv_ctr += 1
        return self._recv.decrypt(nonce, ciphertext, None)  # raises on tamper


def fresh_keypair() -> Tuple[X25519PrivateKey, bytes]:
    priv = X25519PrivateKey.generate()
    return priv, priv.public_key().public_bytes_raw()


def derive_cipher(
    priv: X25519PrivateKey,
    peer_pub: bytes,
    client_pub: bytes,
    server_pub: bytes,
    token: str,
    is_server: bool,
) -> ChannelCipher:
    ss = priv.exchange(X25519PublicKey.from_public_bytes(peer_pub))
    salt = client_pub + server_pub
    token_h = hashlib.sha256(token.encode()).digest()

    def _hk(label: bytes) -> bytes:
        return HKDF(
            algorithm=SHA256(), length=32, salt=salt,
            info=b"mpcium-tpu/bus/" + label + token_h,
        ).derive(ss)

    k_c2s, k_s2c = _hk(b"c2s"), _hk(b"s2c")
    if is_server:
        return ChannelCipher(send_key=k_s2c, recv_key=k_c2s)
    return ChannelCipher(send_key=k_c2s, recv_key=k_s2c)


def hash_token(token: str) -> str:
    """Canonical stored form of a broker token: sha256:<hex>. Accepts an
    already-hashed value unchanged.

    The digest form is itself a FULL broker credential (it authenticates
    and keys the AEAD channel — deliberately so, which is how a standby
    broker configured with only the digest can follow its primary).
    Holding the digest in config instead of the raw token protects only
    one thing: a raw token reused across systems is not exposed to
    whoever reads this config. Treat ``sha256:<hex>`` values with the
    same care as the secret (SECURITY.md "Broker channel")."""
    if token.startswith("sha256:"):
        return token
    return "sha256:" + hashlib.sha256(token.encode()).hexdigest()


def token_matches(presented: str, stored: str) -> bool:
    import hmac as _hmac

    return _hmac.compare_digest(hash_token(presented), hash_token(stored))
