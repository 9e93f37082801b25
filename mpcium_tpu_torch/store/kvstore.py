"""Key/value stores: encrypted share store + plain control-plane KV.

Reference equivalents:
- encrypted Badger for key shares (pkg/kvstore/badger.go — encryption key
  MANDATORY, badger.go:21-24): here an AEAD-encrypted file-backed store
  (ChaCha20-Poly1305 per value, scrypt-derived master key, atomic writes).
- Consul KV for control plane (pkg/infra/consul.go `ConsulKV` iface:
  Put/Get/Delete/List): here :class:`MemoryKV` (in-process cluster fabric)
  and :class:`FileKV` (multi-process on shared disk).
"""
from __future__ import annotations

import abc
import hashlib
import json
import os
import secrets
import threading
from pathlib import Path
from typing import Dict, List, Optional

try:
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
except ImportError:  # bare env: RFC-vector-validated pure-python fallback
    from ..core.softcrypto import ChaCha20Poly1305


class KVStore(abc.ABC):
    """Reference kvstore.KVStore (kvstore.go:4-16) + Keys iterator."""

    @abc.abstractmethod
    def put(self, key: str, value: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    def keys(self, prefix: str = "") -> List[str]: ...

    def close(self) -> None:
        pass


class EncryptedFileKV(KVStore):
    """Encrypted share store. The encryption key is mandatory (reference
    badger.go:21-24 errors out without one). One file per key under
    ``root``; values sealed with ChaCha20-Poly1305; key names are hashed to
    filenames so the directory listing leaks no wallet ids."""

    def __init__(self, root, password: str):
        if not password:
            raise ValueError("encryption password is required")  # badger.go:23
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        salt_path = self.root / ".salt"
        if salt_path.exists():
            salt = salt_path.read_bytes()
        else:
            salt = secrets.token_bytes(16)
            salt_path.write_bytes(salt)
        self._key = hashlib.scrypt(
            password.encode(), salt=salt, n=2**14, r=8, p=1,
            maxmem=64 * 1024 * 1024, dklen=32,
        )
        self._aead = ChaCha20Poly1305(self._key)
        self._lock = threading.RLock()
        # encrypted name index (filename-hash -> key), itself sealed
        self._index_path = self.root / ".index"
        self._index: Dict[str, str] = {}
        if self._index_path.exists():
            try:
                self._index = json.loads(
                    self._open(self._index_path.read_bytes(), b"index")
                )
            except Exception as e:  # noqa: BLE001 — fail fast at open
                raise ValueError(
                    "wrong encryption password or corrupted store"
                ) from e

    def _fname(self, key: str) -> Path:
        return self.root / self.hashed_name(key)

    # public sealing surface: the session WAL (store/session_wal.py) seals
    # its entries with this store's AEAD + key-derived filenames so WAL
    # files leak exactly as little as the share files next to them
    def hashed_name(self, key: str) -> str:
        return hashlib.sha256(self._key + key.encode()).hexdigest()[:48]

    def seal(self, data: bytes, ad: bytes) -> bytes:
        return self._seal(data, ad)

    def unseal(self, blob: bytes, ad: bytes) -> bytes:
        return self._open(blob, ad)

    def _seal(self, data: bytes, ad: bytes) -> bytes:
        nonce = secrets.token_bytes(12)
        return nonce + self._aead.encrypt(nonce, data, ad)

    def _open(self, blob: bytes, ad: bytes) -> bytes:
        return self._aead.decrypt(blob[:12], blob[12:], ad)

    def _save_index(self) -> None:
        tmp = str(self._index_path) + ".tmp"
        Path(tmp).write_bytes(
            self._seal(json.dumps(self._index).encode(), b"index")
        )
        os.replace(tmp, self._index_path)

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            p = self._fname(key)
            tmp = str(p) + ".tmp"
            Path(tmp).write_bytes(self._seal(value, key.encode()))
            os.replace(tmp, p)
            if self._index.get(p.name) != key:
                self._index[p.name] = key
                self._save_index()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            p = self._fname(key)
            if not p.exists():
                return None
            return self._open(p.read_bytes(), key.encode())

    def delete(self, key: str) -> None:
        with self._lock:
            p = self._fname(key)
            if p.exists():
                p.unlink()
            if p.name in self._index:
                del self._index[p.name]
                self._save_index()

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._index.values() if k.startswith(prefix))


class MemoryKV(KVStore):
    """In-process control-plane KV (the Consul analogue for loopback
    clusters); shared by reference `ConsulKV` consumers (registry, keyinfo,
    peers)."""

    def __init__(self):
        self._d: Dict[str, bytes] = {}
        self._lock = threading.RLock()

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._d[key] = value

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._d.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._d.pop(key, None)

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._d if k.startswith(prefix))


class FileKV(KVStore):
    """Shared-disk control-plane KV for multi-process deployments (each key
    is a file; names are percent-encoded). Suitable for a docker-compose
    style dev stack on one host; production control planes plug in their
    own KVStore (etcd/Consul adapters)."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()

    @staticmethod
    def _enc(key: str) -> str:
        import urllib.parse

        return urllib.parse.quote(key, safe="")

    @staticmethod
    def _dec(name: str) -> str:
        import urllib.parse

        return urllib.parse.unquote(name)

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            p = self.root / self._enc(key)
            tmp = str(p) + ".tmp"
            Path(tmp).write_bytes(value)
            os.replace(tmp, p)

    def get(self, key: str) -> Optional[bytes]:
        p = self.root / self._enc(key)
        try:
            return p.read_bytes()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        with self._lock:
            p = self.root / self._enc(key)
            if p.exists():
                p.unlink()

    def keys(self, prefix: str = "") -> List[str]:
        return sorted(
            self._dec(p.name)
            for p in self.root.iterdir()
            if not p.name.endswith(".tmp") and self._dec(p.name).startswith(prefix)
        )
