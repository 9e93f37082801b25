"""Protocol plumbing: the durable keygen share, the Shamir x-coordinate
map, round messages, the snapshot codec and the party base class (the
port's copies of the JAX package's ``protocol/base.py`` definitions,
same JSON form).

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


# ---------------------------------------------------------------------------
# snapshot codec (crash-recoverable sessions)
#
# Party state mixes JSON-safe payload dicts (the inbox) with protocol
# secrets: python ints, bytes, curve points, Paillier and MtA objects. A
# snapshot carries all of it through JSON with explicit tags. Every plain
# dict becomes a ``{"__d": [[k, v], ...]}`` pair list, so a payload dict
# is never mistaken for a tag and non-string keys survive (Shamir share
# maps are keyed by int x-coordinates). The tags and the registered type
# names are the JAX package's, so a snapshot reads the same in both.
# ---------------------------------------------------------------------------

_SNAP_TYPES: Dict[str, tuple] = {}  # name -> (cls, encode_fn, decode_fn)


def register_snap_type(name: str, cls, enc, dec) -> None:
    """Register a type for party snapshots: ``enc`` maps an instance to a
    JSON-safe value, ``dec`` inverts it."""
    _SNAP_TYPES[name] = (cls, enc, dec)


def _ensure_snap_types() -> None:
    """Register the crypto types the parties store, on first use: the
    MtA module imports zk, which imports Paillier, so registering them at
    import would make ``protocol.base`` part of an import cycle."""
    if "edpoint" in _SNAP_TYPES:
        return
    from ..core import hostmath as hm
    from ..core.paillier import PaillierPublicKey, PreParams
    from .ecdsa.mta import MtaInit, MtaResp

    register_snap_type(
        "edpoint", hm.EdPoint,
        lambda p: hm.ed_compress(p).hex(),
        lambda v: hm.ed_decompress(bytes.fromhex(v)),
    )
    register_snap_type(
        "secppoint", hm.SecpPoint,
        lambda p: "" if p.is_infinity else hm.secp_compress(p).hex(),
        lambda v: hm.SECP_INF if v == "" else hm.secp_decompress(bytes.fromhex(v)),
    )
    register_snap_type(
        "paillier_pk", PaillierPublicKey,
        lambda pk: str(pk.N),
        lambda v: PaillierPublicKey(int(v)),
    )
    # a restarted node draws DIFFERENT preparams from its pool: a party
    # mid-keygen resumes with the material its round 1 committed to
    register_snap_type("preparams", PreParams, lambda p: p.to_json(), PreParams.from_json)
    register_snap_type("keygen_share", KeygenShare, lambda s: s.to_json(),
                       KeygenShare.from_json)
    register_snap_type("mta_init", MtaInit, lambda m: m.to_json(), MtaInit.from_json)
    register_snap_type("mta_resp", MtaResp, lambda m: m.to_json(), MtaResp.from_json)


def snap_encode(v: Any) -> Any:
    """Party state → JSON-safe tagged value (see the comment above)."""
    if v is None or isinstance(v, (bool, str, float)):
        return v
    if isinstance(v, int):
        return {"__i": str(v)}
    if isinstance(v, (bytes, bytearray)):
        return {"__b": bytes(v).hex()}
    if isinstance(v, list):
        return [snap_encode(x) for x in v]
    if isinstance(v, tuple):
        return {"__t": [snap_encode(x) for x in v]}
    if isinstance(v, dict):
        return {"__d": [[snap_encode(k), snap_encode(x)] for k, x in v.items()]}
    _ensure_snap_types()
    for name, (cls, enc, _dec) in _SNAP_TYPES.items():
        if isinstance(v, cls):
            return {"__o": [name, enc(v)]}
    raise TypeError(f"snapshot cannot encode {type(v).__name__}")


def snap_decode(v: Any) -> Any:
    if v is None or isinstance(v, (bool, str, float)):
        return v
    if isinstance(v, list):
        return [snap_decode(x) for x in v]
    if isinstance(v, dict):
        if "__i" in v:
            return int(v["__i"])
        if "__b" in v:
            return bytes.fromhex(v["__b"])
        if "__t" in v:
            return tuple(snap_decode(x) for x in v["__t"])
        if "__d" in v:
            return {snap_decode(k): snap_decode(x) for k, x in v["__d"]}
        if "__o" in v:
            name, payload = v["__o"]
            _ensure_snap_types()
            if name not in _SNAP_TYPES:
                raise TypeError(f"snapshot references unknown type {name!r}")
            return _SNAP_TYPES[name][2](payload)
    # structure only: a snapshot holds share material, and the value's
    # repr must never reach an exception message
    tags = sorted(v) if isinstance(v, dict) else ()
    raise TypeError(
        f"snapshot cannot decode value of type {type(v).__name__} (tags: {list(tags)})"
    )


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

    # -- crash-recovery snapshots -------------------------------------------
    #
    # ``snapshot()`` captures the party's message-driven state: the inbox
    # plus every attribute named in ``_SNAP_EXTRA`` (the protocol's
    # secrets — nonces, Shamir coefficients, commitments — whose loss
    # would change the transcript on resume). ``restore()`` puts it onto a
    # fresh party built with the same constructor arguments. Attributes
    # not made yet (rounds not reached) are absent and stay absent.

    _SNAP_EXTRA: Sequence[str] = ()

    def snapshot(self) -> Dict[str, Any]:
        extra = {}
        for name in self._SNAP_EXTRA:
            if hasattr(self, name):
                extra[name] = snap_encode(getattr(self, name))
        return {
            "v": 1,
            "protocol": type(self).__name__,
            "session_id": self.session_id,
            "done": self.done,
            "result": snap_encode(self.result),
            "inbox": snap_encode(self._inbox),
            "extra": extra,
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        if snap.get("protocol") != type(self).__name__:
            raise ProtocolError(
                f"snapshot for {snap.get('protocol')!r} restored into {type(self).__name__}"
            )
        if snap.get("session_id") != self.session_id:
            raise ProtocolError(
                f"snapshot for session {snap.get('session_id')!r} restored into "
                f"{self.session_id!r}"
            )
        self._inbox = snap_decode(snap["inbox"])
        for name, v in snap.get("extra", {}).items():
            setattr(self, name, snap_decode(v))
        self.done = bool(snap.get("done", False))
        self.result = snap_decode(snap.get("result"))
        self._post_restore()

    def _post_restore(self) -> None:
        """Recompute derived (unserialized) state; a per-protocol hook."""

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
