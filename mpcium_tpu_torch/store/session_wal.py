"""Encrypted per-session write-ahead log — crash-recoverable sessions.

Every in-flight MPC session journals (a) each *verified* inbound envelope
and (b) a checkpoint of party state taken immediately before any outbound
round traffic is handed to the transport. After a SIGKILL the daemon
replays the WAL: the party is rebuilt from the last checkpoint, envelopes
that arrived after it are re-delivered, and the already-sent history is
re-routed so peers that missed nothing simply drop duplicates.

Disk format (append-only, one file per session under ``<store>/wal/``)::

    [4-byte BE length][sealed record] ...

Each record is canonical JSON sealed with the *share store's* AEAD
(ChaCha20-Poly1305, scrypt-derived key — see
:class:`~mpcium_tpu_torch.store.kvstore.EncryptedFileKV`), so WAL files leak
exactly as little as the key-share files beside them. The associated data
binds every record to its session id and sequence number
(``wal:<session_id>:<seq>``), which makes records non-spliceable across
files and non-reorderable within one. Record 0 is the ``meta`` record,
sealed under a fixed AD (``wal:meta``) because it is what *tells* us the
session id at replay time; its payload carries the id that all later
records are bound to.

Record types::

    {"t": "meta", "session_id": ..., "meta": {...}}   # session factory args
    {"t": "env",  "raw": <hex>}                       # verified inbound envelope
    {"t": "ckpt", "snap": {...}, "sent": [...]}       # party state + step outputs
    {"t": "done"}                                     # session completed

Durability: each append is flushed and ``fsync``'d before the caller
proceeds (checkpoints are written *before* the corresponding messages are
routed — a crashed party must never re-derive fresh randomness for
payloads peers already saw). A torn or corrupted tail — short frame,
absurd length, failed AEAD open — is tolerated: replay stops at the last
intact record and :meth:`SessionWALStore.reopen` truncates the garbage, so
recovery falls back to the previous checkpoint instead of crashing.
"""
from __future__ import annotations

import json
import os
import struct
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from .kvstore import EncryptedFileKV

_LEN = struct.Struct(">I")
_META_AD = b"wal:meta"
# sanity bound on a single sealed record; anything larger is a torn/garbage
# length prefix, not a real record (checkpoints are a few hundred KB at most)
_MAX_RECORD = 64 * 1024 * 1024


def _ad(session_id: str, seq: int) -> bytes:
    return f"wal:{session_id}:{seq}".encode()


@dataclass
class WALReplay:
    """Result of replaying one WAL file up to its last intact record."""

    path: Path
    session_id: str = ""
    meta: Dict[str, Any] = field(default_factory=dict)
    snapshot: Optional[Dict[str, Any]] = None
    #: full sent history (concatenation of every checkpoint's step outputs)
    sent: List[Dict[str, Any]] = field(default_factory=list)
    #: raw verified envelopes received *after* the last checkpoint
    envelopes: List[bytes] = field(default_factory=list)
    done: bool = False
    records: int = 0
    valid_bytes: int = 0
    torn: bool = False


class SessionWALWriter:
    """Append handle for one session's WAL. Thread-safe; every append is
    fsync'd before returning (unless the store was built with
    ``fsync=False``, which only tests use)."""

    def __init__(
        self,
        store: EncryptedFileKV,
        path: Path,
        session_id: str,
        seq: int = 0,
        fsync: bool = True,
    ):
        self._store = store
        self.path = path
        self.session_id = session_id
        self._seq = seq
        self._fsync = fsync
        self._lock = threading.Lock()
        self._f = open(path, "ab")

    def _append(self, rec: Dict[str, Any]) -> None:
        data = json.dumps(rec, separators=(",", ":"), sort_keys=True).encode()
        with self._lock:
            if self._f is None:
                return  # closed/dropped: session outlived its WAL, ignore
            ad = _META_AD if self._seq == 0 else _ad(self.session_id, self._seq)
            sealed = self._store.seal(data, ad)
            self._f.write(_LEN.pack(len(sealed)) + sealed)
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
            self._seq += 1

    def meta(self, meta: Dict[str, Any]) -> None:
        """Record 0: everything the node needs to rebuild the session
        object (protocol kind, participants, message bytes, ...)."""
        self._append({"t": "meta", "session_id": self.session_id, "meta": meta})

    def envelope(self, raw: bytes) -> None:
        """A verified inbound envelope, journaled before delivery."""
        self._append({"t": "env", "raw": raw.hex()})

    def checkpoint(self, snap: Dict[str, Any], sent: List[Dict[str, Any]]) -> None:
        """Party state plus the outputs of this step — written *before* the
        outputs are routed, so replay reuses the exact payloads peers saw."""
        self._append({"t": "ckpt", "snap": snap, "sent": sent})

    def done(self) -> None:
        self._append({"t": "done"})

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def drop(self) -> None:
        """Close and delete — the session completed (or terminally failed)."""
        self.close()
        try:
            self.path.unlink()
        except FileNotFoundError:
            pass


class SessionWALStore:
    """Per-node WAL namespace under the encrypted share store's root.

    Filenames are key-derived hashes (like the share files), so a directory
    listing leaks neither wallet ids nor session counts' meanings.
    """

    def __init__(self, store: EncryptedFileKV, fsync: bool = True):
        self.store = store
        self.dir = store.root / "wal"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync

    def _path(self, session_id: str) -> Path:
        return self.dir / (self.store.hashed_name("wal:" + session_id) + ".wal")

    # -- writing ------------------------------------------------------------

    def create(self, session_id: str, meta: Dict[str, Any]) -> SessionWALWriter:
        """Fresh WAL for a new session (any stale file for the same id —
        e.g. an earlier failed run — is discarded first)."""
        path = self._path(session_id)
        if path.exists():
            path.unlink()
        w = SessionWALWriter(self.store, path, session_id, fsync=self.fsync)
        w.meta(meta)
        return w

    def reopen(self, replay: WALReplay) -> SessionWALWriter:
        """Continue appending after the last intact record of a replayed
        file; a torn tail is truncated away here."""
        if replay.torn or replay.path.stat().st_size != replay.valid_bytes:
            with open(replay.path, "r+b") as f:
                f.truncate(replay.valid_bytes)
        return SessionWALWriter(
            self.store,
            replay.path,
            replay.session_id,
            seq=replay.records,
            fsync=self.fsync,
        )

    def drop(self, session_id: str) -> None:
        try:
            self._path(session_id).unlink()
        except FileNotFoundError:
            pass

    # -- replay -------------------------------------------------------------

    def replay(self, path: Path) -> Optional[WALReplay]:
        """Replay one file up to the last intact record. Returns ``None``
        when not even the meta record survives (nothing to resume)."""
        try:
            blob = path.read_bytes()
        except OSError:
            return None
        rep = WALReplay(path=path)
        off = 0
        while True:
            if off + _LEN.size > len(blob):
                rep.torn = rep.torn or off != len(blob)
                break
            (ln,) = _LEN.unpack_from(blob, off)
            if ln == 0 or ln > _MAX_RECORD or off + _LEN.size + ln > len(blob):
                rep.torn = True
                break
            sealed = blob[off + _LEN.size : off + _LEN.size + ln]
            ad = _META_AD if rep.records == 0 else _ad(rep.session_id, rep.records)
            try:
                rec = json.loads(self.store.unseal(sealed, ad))
                if rep.records == 0:
                    if rec.get("t") != "meta":
                        raise ValueError("first record is not meta")
                    rep.session_id = rec["session_id"]
                    rep.meta = rec.get("meta", {})
                elif rec["t"] == "env":
                    rep.envelopes.append(bytes.fromhex(rec["raw"]))
                elif rec["t"] == "ckpt":
                    rep.snapshot = rec["snap"]
                    rep.sent.extend(rec.get("sent", []))
                    # pre-checkpoint envelopes live inside the snapshot's
                    # inbox already; only post-checkpoint ones need redelivery
                    rep.envelopes.clear()
                elif rec["t"] == "done":
                    rep.done = True
            except Exception:  # noqa: BLE001 — torn/corrupt tail, stop here
                rep.torn = True
                break
            rep.records += 1
            off += _LEN.size + ln
            rep.valid_bytes = off
        if rep.records == 0:
            return None
        return rep

    def incomplete(self) -> List[WALReplay]:
        """All sessions with a readable meta record and no ``done`` marker —
        the resume set scanned at daemon boot."""
        out: List[WALReplay] = []
        for p in sorted(self.dir.glob("*.wal")):
            rep = self.replay(p)
            if rep is not None and not rep.done:
                out.append(rep)
        return out
