"""Protocol plumbing: the durable keygen share, the Shamir x-coordinate
map, round messages and the party base class (the port's copies of the
JAX package's ``protocol/base.py`` definitions, same JSON form).

A party consumes and produces :class:`RoundMsg` values; routing lives in
higher layers, so the protocol runs transport-free and deterministic
in-process (``protocol/runner.py``). Payloads are JSON-safe (ints as
decimal strings, bytes as hex).
"""
from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils import tracing


class ProtocolError(Exception):
    """Protocol violation attributable to a peer (culprit recorded)."""

    def __init__(self, message: str, culprit: Optional[str] = None):
        super().__init__(message + (f" (culprit: {culprit})" if culprit else ""))
        self.culprit = culprit


@dataclass(frozen=True)
class RoundMsg:
    """One protocol message; ``to`` is None for broadcast, else the
    recipient party ID."""

    session_id: str
    round: str
    from_id: str
    payload: Dict[str, Any]
    to: Optional[str] = None

    @property
    def is_broadcast(self) -> bool:
        return self.to is None


def party_xs(party_ids: Sequence[str]) -> Dict[str, int]:
    """Deterministic Shamir x-coordinates: 1-based rank in the sorted ID
    list, so every party derives the same map from the same set."""
    return {pid: i + 1 for i, pid in enumerate(sorted(party_ids))}


@dataclass
class KeygenShare:
    """Durable per-wallet share record."""

    key_type: str  # "ed25519" | "secp256k1"
    share: int  # Shamir share of the secret key, f(self_x)
    self_x: int
    public_key: bytes  # compressed group encoding
    vss_commitments: List[bytes] = field(default_factory=list)
    participants: List[str] = field(default_factory=list)
    threshold: int = 0
    epoch: int = 0
    aux: Dict[str, Any] = field(default_factory=dict)  # scheme-specific

    def to_json(self) -> Dict[str, Any]:
        return {
            "key_type": self.key_type,
            "share": str(self.share),
            "self_x": self.self_x,
            "public_key": self.public_key.hex(),
            "vss_commitments": [c.hex() for c in self.vss_commitments],
            "participants": self.participants,
            "threshold": self.threshold,
            "epoch": self.epoch,
            "aux": self.aux,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "KeygenShare":
        return cls(
            key_type=d["key_type"],
            share=int(d["share"]),
            self_x=d["self_x"],
            public_key=bytes.fromhex(d["public_key"]),
            vss_commitments=[bytes.fromhex(c) for c in d["vss_commitments"]],
            participants=list(d["participants"]),
            threshold=d["threshold"],
            epoch=int(d.get("epoch", 0)),
            aux=dict(d.get("aux", {})),
        )


class PartyBase:
    """Common state for a protocol party.

    Subclasses implement ``start() -> [RoundMsg]`` and
    ``receive(RoundMsg) -> [RoundMsg]``; when ``done`` flips True the
    ``result`` is available. Errors raise :class:`ProtocolError`.
    """

    def __init__(self, session_id: str, self_id: str, party_ids: Sequence[str],
                 rng=secrets):
        assert self_id in party_ids
        self.session_id = session_id
        self.self_id = self_id
        self.party_ids = sorted(party_ids)
        self.xs = party_xs(self.party_ids)
        self.self_x = self.xs[self_id]
        self.rng = rng
        self.done = False
        self.result: Any = None
        # per-round inbox: round name -> {from_id: payload}
        self._inbox: Dict[str, Dict[str, Dict[str, Any]]] = {}

    # -- inbox machinery ----------------------------------------------------

    def _store(self, msg: RoundMsg) -> None:
        if msg.session_id != self.session_id:
            raise ProtocolError(
                f"message for session {msg.session_id!r} delivered to "
                f"{self.session_id!r}"
            )
        if msg.from_id not in self.xs:
            raise ProtocolError("message from non-participant", msg.from_id)
        if msg.to is not None and msg.to != self.self_id:
            raise ProtocolError(f"unicast for {msg.to!r} delivered to {self.self_id!r}")
        box = self._inbox.setdefault(msg.round, {})
        if msg.from_id in box:
            # duplicate delivery is legal (at-least-once transport) only
            # when identical; anything else is equivocation
            if box[msg.from_id] != msg.payload:
                raise ProtocolError(f"equivocation in round {msg.round}", msg.from_id)
            return
        box[msg.from_id] = msg.payload

    def _round_full(self, round_name: str, expect_from: Sequence[str]) -> bool:
        box = self._inbox.get(round_name, {})
        return all(pid in box for pid in expect_from)

    def _round_payloads(self, round_name: str) -> Dict[str, Dict[str, Any]]:
        return self._inbox.get(round_name, {})

    # -- helpers ------------------------------------------------------------

    def others(self) -> List[str]:
        return [p for p in self.party_ids if p != self.self_id]

    def broadcast(self, round_name: str, payload: Dict[str, Any]) -> RoundMsg:
        return RoundMsg(self.session_id, round_name, self.self_id, payload)

    def unicast(self, to: str, round_name: str, payload: Dict[str, Any]) -> RoundMsg:
        return RoundMsg(self.session_id, round_name, self.self_id, payload, to=to)


class BatchBlockMixin:
    """Fixed-shape byte-block helpers shared by the batched parties (the
    ECDSA signing party and the DKG/reshare parties). The host class
    provides ``session_id``, ``self_id``, ``B`` and ``device``.

    ``_bind_row`` is security-relevant: the (B, 32) session+sender row is
    hashed into every commitment and proof, so a transcript replayed from
    another session or attributed to another party fails to verify. One
    definition serves every batched protocol, so it cannot drift.
    """

    session_id: str
    self_id: str
    B: int
    device: torch.device

    def _bind_row(self, pid: str) -> torch.Tensor:
        h = hashlib.sha256(f"{self.session_id}:{pid}".encode()).digest()
        row = torch.tensor(list(h), dtype=torch.uint8, device=self.device)
        return row.expand(self.B, 32)

    def _phase(self, name: str):
        """A span around one of this party's protocol phases."""
        return tracing.span(f"phase:{name}", node=self.self_id, batch=self.B)

    def _parse_block(self, hexstr: str, nbytes: int, pid: str) -> np.ndarray:
        """A hex block of B rows of ``nbytes`` → (B, nbytes) uint8; a
        malformed or wrong-size block is the sender's ProtocolError."""
        try:
            raw = bytes.fromhex(hexstr)
        except ValueError:
            raise ProtocolError("non-hex block", pid)
        if len(raw) != self.B * nbytes:
            raise ProtocolError(f"bad block size {len(raw)} != {self.B}x{nbytes}", pid)
        return np.frombuffer(bytearray(raw), dtype=np.uint8).reshape(self.B, nbytes)
