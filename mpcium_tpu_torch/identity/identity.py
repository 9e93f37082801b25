"""Node/initiator identities and message authentication.

Reference behavior (pkg/identity/identity.go): every node holds an Ed25519
identity keypair; every cross-node protocol message is signed over canonical
bytes and verified against the sender's registered public key; initiator
commands are verified against the configured initiator public key; private
keys at rest are optionally passphrase-encrypted (age scrypt —
identity.go:160-177). Peer public keys are cross-validated at startup
(identity.go:81-125).

Implementation: OpenSSL Ed25519 via `cryptography` (host control-plane —
envelope auth is not protocol math), scrypt + ChaCha20-Poly1305 for at-rest
encryption (the age-equivalent authenticated passphrase scheme).
"""
from __future__ import annotations

import hashlib
import json
import os
import secrets
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
except ImportError:  # bare env: RFC-vector-validated pure-python fallback
    from ..core.softcrypto import (
        ChaCha20Poly1305,
        Ed25519PrivateKey,
        Ed25519PublicKey,
        InvalidSignature,
        serialization,
    )

from ..wire import Envelope

ENC_SUFFIX = ".enc"  # the age-equivalent encrypted container suffix

# scrypt parameters (age defaults are N=2^18; interactive-friendly here)
_SCRYPT_N = 2**15
_SCRYPT_R = 8
_SCRYPT_P = 1


class IdentityError(Exception):
    pass


def _write_private_file(path, data: bytes) -> None:
    """Create/overwrite a key file with 0600 permissions — signing keys must
    not be world-readable on multi-user hosts."""
    p = Path(path)
    fd = os.open(str(p), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        # mpclint: disable=MPF703 — this IS the at-rest identity key store: 0600 file, scrypt+AEAD-wrapped when a passphrase is set
        os.write(fd, data)
    finally:
        os.close(fd)


def _derive_key(passphrase: str, salt: bytes) -> bytes:
    return hashlib.scrypt(
        passphrase.encode(), salt=salt, n=_SCRYPT_N, r=_SCRYPT_R, p=_SCRYPT_P,
        maxmem=128 * 1024 * 1024, dklen=32,
    )


def encrypt_private_bytes(data: bytes, passphrase: str) -> bytes:
    """scrypt + ChaCha20-Poly1305 container: salt ‖ nonce ‖ ciphertext."""
    salt = secrets.token_bytes(16)
    nonce = secrets.token_bytes(12)
    ct = ChaCha20Poly1305(_derive_key(passphrase, salt)).encrypt(nonce, data, b"")
    return salt + nonce + ct


def decrypt_private_bytes(blob: bytes, passphrase: str) -> bytes:
    salt, nonce, ct = blob[:16], blob[16:28], blob[28:]
    try:
        return ChaCha20Poly1305(_derive_key(passphrase, salt)).decrypt(nonce, ct, b"")
    except Exception as e:  # noqa: BLE001 — wrong passphrase or corrupt
        raise IdentityError(f"cannot decrypt private key: {e}") from e


@dataclass
class NodeIdentity:
    node_id: str
    public_key: bytes  # 32-byte raw Ed25519

    def to_json(self) -> dict:
        return {"node_id": self.node_id, "public_key": self.public_key.hex()}

    @classmethod
    def from_json(cls, d: dict) -> "NodeIdentity":
        return cls(node_id=d["node_id"], public_key=bytes.fromhex(d["public_key"]))


def generate_identity(
    node_id: str,
    out_dir,
    passphrase: Optional[str] = None,
) -> NodeIdentity:
    """Create `<node>_identity.json` + `<node>_private.key[.enc]` (reference
    mpcium-cli generate-identity)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    sk = Ed25519PrivateKey.generate()
    raw = sk.private_bytes(
        serialization.Encoding.Raw,
        serialization.PrivateFormat.Raw,
        serialization.NoEncryption(),
    )
    pub = sk.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )
    ident = NodeIdentity(node_id=node_id, public_key=pub)
    (out / f"{node_id}_identity.json").write_text(json.dumps(ident.to_json(), indent=1))
    key_path = out / f"{node_id}_private.key"
    if passphrase is not None:
        if len(passphrase) < 12 or not any(not c.isalnum() for c in passphrase):
            # reference password policy: ≥12 chars incl. special
            # (generate-identity.go:53-63)
            raise IdentityError(
                "passphrase must be ≥12 chars and contain a special character"
            )
        _write_private_file(
            str(key_path) + ENC_SUFFIX,
            encrypt_private_bytes(raw.hex().encode(), passphrase),
        )
    else:
        _write_private_file(key_path, raw.hex().encode())
    return ident


class IdentityStore:
    """Loads own private key + all peers' public keys; signs/verifies
    envelopes and initiator messages (reference identity.Store iface,
    identity.go:32-38)."""

    def __init__(
        self,
        identity_dir,
        node_id: str,
        peers: Dict[str, str],  # name -> peer uuid/nodeID (peers.json)
        initiator_pubkey: Optional[bytes] = None,
        passphrase: Optional[str] = None,
    ):
        d = Path(identity_dir)
        self.node_id = node_id
        self.initiator_pubkey = initiator_pubkey
        self._pub: Dict[str, Ed25519PublicKey] = {}
        # startup cross-validation (identity.go:81-125): every peer in the
        # topology must have an identity file and the IDs must match
        for name in sorted(peers):
            path = d / f"{name}_identity.json"
            if not path.exists():
                raise IdentityError(f"missing identity file for peer {name!r}")
            ident = NodeIdentity.from_json(json.loads(path.read_text()))
            if ident.node_id != name:
                raise IdentityError(
                    f"identity file {path} declares node_id {ident.node_id!r}, "
                    f"expected {name!r}"
                )
            self._pub[name] = Ed25519PublicKey.from_public_bytes(ident.public_key)
        if node_id not in self._pub:
            raise IdentityError(f"own identity {node_id!r} not in peer set")
        # own private key (hex file or encrypted container)
        key_path = d / f"{node_id}_private.key"
        enc_path = Path(str(key_path) + ENC_SUFFIX)
        if enc_path.exists():
            if passphrase is None:
                raise IdentityError("private key is encrypted; passphrase required")
            raw = bytes.fromhex(
                decrypt_private_bytes(enc_path.read_bytes(), passphrase).decode()
            )
        elif key_path.exists():
            raw = bytes.fromhex(key_path.read_text().strip())
        else:
            raise IdentityError(f"no private key for {node_id!r} in {d}")
        self._sk = Ed25519PrivateKey.from_private_bytes(raw)
        own_pub = self._sk.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
        declared = self._pub[node_id].public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
        if own_pub != declared:
            raise IdentityError("private key does not match published identity")

    # -- envelope auth ------------------------------------------------------

    def sign_envelope(self, env: Envelope) -> None:
        env.signature = self._sk.sign(env.marshal_for_signing())

    def verify_envelope(self, env: Envelope) -> bool:
        pub = self._pub.get(env.from_id)
        if pub is None or not env.signature:
            return False
        try:
            pub.verify(env.signature, env.marshal_for_signing())
            return True
        except InvalidSignature:
            return False

    # -- raw message auth (batch manifests etc.) ----------------------------

    def sign_raw(self, raw: bytes) -> bytes:
        return self._sk.sign(raw)

    def verify_peer(self, node_id: str, raw: bytes, signature: bytes) -> bool:
        pub = self._pub.get(node_id)
        if pub is None or not signature:
            return False
        try:
            pub.verify(signature, raw)
            return True
        except InvalidSignature:
            return False

    # -- initiator auth -----------------------------------------------------

    def verify_initiator(self, raw: bytes, signature: bytes) -> bool:
        if self.initiator_pubkey is None or not signature:
            return False
        try:
            Ed25519PublicKey.from_public_bytes(self.initiator_pubkey).verify(
                signature, raw
            )
            return True
        except InvalidSignature:
            return False

    def public_key(self, node_id: str) -> bytes:
        return self._pub[node_id].public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )


@dataclass
class InitiatorKey:
    """Client-side initiator signing key (reference event_initiator.key,
    client.go:64-146)."""

    _sk: Ed25519PrivateKey

    @classmethod
    def generate(cls) -> "InitiatorKey":
        return cls(_sk=Ed25519PrivateKey.generate())

    @classmethod
    def load(cls, path, passphrase: Optional[str] = None) -> "InitiatorKey":
        p = Path(path)
        enc = Path(str(p) + ENC_SUFFIX)
        if enc.exists():
            if passphrase is None:
                raise IdentityError("initiator key is encrypted; passphrase required")
            raw = bytes.fromhex(
                decrypt_private_bytes(enc.read_bytes(), passphrase).decode()
            )
        else:
            raw = bytes.fromhex(p.read_text().strip())
        return cls(_sk=Ed25519PrivateKey.from_private_bytes(raw))

    def save(self, path, passphrase: Optional[str] = None) -> None:
        raw = self._sk.private_bytes(
            serialization.Encoding.Raw,
            serialization.PrivateFormat.Raw,
            serialization.NoEncryption(),
        )
        if passphrase is not None:
            _write_private_file(
                str(path) + ENC_SUFFIX,
                encrypt_private_bytes(raw.hex().encode(), passphrase),
            )
        else:
            _write_private_file(path, raw.hex().encode())

    @property
    def public_bytes(self) -> bytes:
        return self._sk.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )

    def sign(self, raw: bytes) -> bytes:
        return self._sk.sign(raw)
