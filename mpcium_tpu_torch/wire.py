"""Wire types: signed envelopes and initiator commands (the port's copy
of the JAX package's ``wire.py``; every schema, constant and byte below
is a wire contract, so a GPU node and a TPU node of one committee
interoperate).

JSON schemas mirror the reference's `pkg/types` (tss.go:13-24,
initiator_msg.go) so that results/events are byte-compatible where the
survey pins them (§7.1 item 4). Canonical signing bytes follow the
reference's MarshalForSigning contract (types/tss.go:149-163): a sorted-key
JSON object of the protocol-relevant fields — signatures must not cover
themselves.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Optional

KEY_TYPE_SECP256K1 = "secp256k1"
KEY_TYPE_ED25519 = "ed25519"

# deadline lanes (SLO-aware continuous batching). ``priority`` selects the
# dispatch lane; ``deadline_ms`` is the client's end-to-end latency budget
# (0 ⇒ take the server-side config default). Both are omitted from signing
# bytes and JSON when default so legacy messages stay byte-identical.
PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BULK = "bulk"
PRIORITIES = (PRIORITY_INTERACTIVE, PRIORITY_BULK)


def canonical_json(obj: Any) -> bytes:
    """Deterministic JSON: sorted keys, no whitespace, UTF-8. The batched
    ECDSA party also hashes the quorum's Paillier/ring-Pedersen material
    through it, so the bytes are a wire constant."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# protocol round envelope (the TssMessage analogue)
# ---------------------------------------------------------------------------


@dataclass
class Envelope:
    """Signed protocol-round message (reference types.TssMessage).

    ``session_id`` doubles as the wallet/tx scope; ``payload`` carries the
    protocol round content (JSON-safe; batched rounds use base64 byte
    tensors). ``to`` empty ⇒ broadcast.
    """

    session_id: str
    round: str
    from_id: str
    payload: Dict[str, Any]
    to: Optional[str] = None
    is_broadcast: bool = True
    signature: bytes = b""
    # wire schema version. 0 is the v0 shape and is omitted from JSON (and
    # never covered by signing bytes), so legacy signed envelopes stay
    # byte-identical; bump only with a parser that handles both.
    v: int = 0
    # mpctrace context ({"t": trace_id, "s": span_id}): observability
    # metadata, same omit-while-default contract as ``v`` — absent from
    # JSON when None and NEVER covered by signing bytes, so legacy peers
    # ignore it and traced envelopes verify against untraced signatures.
    # Unauthenticated by design; must never feed a protocol decision.
    trace: Optional[Dict[str, str]] = None

    def marshal_for_signing(self) -> bytes:
        return canonical_json(
            {
                "session_id": self.session_id,
                "round": self.round,
                "from": self.from_id,
                "to": self.to or "",
                "is_broadcast": self.is_broadcast,
                "payload": self.payload,
            }
        )

    def to_json(self) -> Dict[str, Any]:
        out = {
            "session_id": self.session_id,
            "round": self.round,
            "from": self.from_id,
            "to": self.to,
            "is_broadcast": self.is_broadcast,
            "payload": self.payload,
            "signature": self.signature.hex(),
        }
        if self.v:
            out["v"] = self.v
        if self.trace:
            out["trace"] = self.trace
        return out

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Envelope":
        return cls(
            session_id=d["session_id"],
            round=d["round"],
            from_id=d["from"],
            payload=d["payload"],
            to=d.get("to"),
            is_broadcast=d.get("is_broadcast", True),
            signature=bytes.fromhex(d.get("signature", "")),
            v=int(d.get("v", 0)),
            trace=d.get("trace"),
        )

    def encode(self) -> bytes:
        return canonical_json(self.to_json())

    @classmethod
    def decode(cls, raw: bytes) -> "Envelope":
        return cls.from_json(json.loads(raw))


# ---------------------------------------------------------------------------
# initiator commands (client → nodes)
# ---------------------------------------------------------------------------


@dataclass
class GenerateKeyMessage:
    """reference types.GenerateKeyMessage: raw = wallet id bytes."""

    wallet_id: str
    signature: bytes = b""
    v: int = 0

    def raw(self) -> bytes:
        return self.wallet_id.encode()

    def to_json(self) -> Dict[str, Any]:
        out = {"wallet_id": self.wallet_id, "signature": self.signature.hex()}
        if self.v:
            out["v"] = self.v
        return out

    @classmethod
    def from_json(cls, d) -> "GenerateKeyMessage":
        return cls(
            wallet_id=d["wallet_id"],
            signature=bytes.fromhex(d.get("signature", "")),
            v=int(d.get("v", 0)),
        )


@dataclass
class SignTxMessage:
    """reference types.SignTxMessage (initiator_msg.go:27-34): raw = JSON
    minus signature (sorted keys)."""

    key_type: str
    wallet_id: str
    network_internal_code: str
    tx_id: str
    tx: bytes

    signature: bytes = b""
    # SLO hints: 0/bulk are the wire defaults and are omitted from signing
    # bytes + JSON, so legacy signed messages keep their exact byte shape.
    deadline_ms: int = 0
    priority: str = PRIORITY_BULK
    # schema version, same omit-while-0 contract as the SLO fields
    v: int = 0

    def _slo_fields(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.deadline_ms:
            out["deadline_ms"] = self.deadline_ms
        if self.priority != PRIORITY_BULK:
            out["priority"] = self.priority
        return out

    def raw(self) -> bytes:
        body = {
            "key_type": self.key_type,
            "wallet_id": self.wallet_id,
            "network_internal_code": self.network_internal_code,
            "tx_id": self.tx_id,
            "tx": self.tx.hex(),
        }
        body.update(self._slo_fields())
        return canonical_json(body)

    def to_json(self) -> Dict[str, Any]:
        out = {
            "key_type": self.key_type,
            "wallet_id": self.wallet_id,
            "network_internal_code": self.network_internal_code,
            "tx_id": self.tx_id,
            "tx": self.tx.hex(),
            "signature": self.signature.hex(),
        }
        out.update(self._slo_fields())
        if self.v:
            out["v"] = self.v
        return out

    @classmethod
    def from_json(cls, d) -> "SignTxMessage":
        return cls(
            key_type=d["key_type"],
            wallet_id=d["wallet_id"],
            network_internal_code=d["network_internal_code"],
            tx_id=d["tx_id"],
            tx=bytes.fromhex(d["tx"]),
            signature=bytes.fromhex(d.get("signature", "")),
            deadline_ms=int(d.get("deadline_ms", 0)),
            priority=d.get("priority", PRIORITY_BULK),
            v=int(d.get("v", 0)),
        )


@dataclass
class ResharingMessage:
    """reference types.ResharingMessage (initiator_msg.go:36-59)."""

    wallet_id: str
    new_threshold: int
    key_type: str
    signature: bytes = b""
    deadline_ms: int = 0
    priority: str = PRIORITY_BULK
    v: int = 0

    def _slo_fields(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.deadline_ms:
            out["deadline_ms"] = self.deadline_ms
        if self.priority != PRIORITY_BULK:
            out["priority"] = self.priority
        return out

    def raw(self) -> bytes:
        body = {
            "wallet_id": self.wallet_id,
            "new_threshold": self.new_threshold,
            "key_type": self.key_type,
        }
        body.update(self._slo_fields())
        return canonical_json(body)

    def to_json(self) -> Dict[str, Any]:
        out = {
            "wallet_id": self.wallet_id,
            "new_threshold": self.new_threshold,
            "key_type": self.key_type,
            "signature": self.signature.hex(),
        }
        out.update(self._slo_fields())
        if self.v:
            out["v"] = self.v
        return out

    @classmethod
    def from_json(cls, d) -> "ResharingMessage":
        return cls(
            wallet_id=d["wallet_id"],
            new_threshold=int(d["new_threshold"]),
            key_type=d["key_type"],
            signature=bytes.fromhex(d.get("signature", "")),
            deadline_ms=int(d.get("deadline_ms", 0)),
            priority=d.get("priority", PRIORITY_BULK),
            v=int(d.get("v", 0)),
        )


# ---------------------------------------------------------------------------
# result events (nodes → client), byte-compatible with event/sign.go:21-34
# ---------------------------------------------------------------------------

RESULT_SUCCESS = "success"
RESULT_ERROR = "error"


@dataclass
class KeygenSuccessEvent:
    """reference mpc.KeygenSuccessEvent: one wallet, both curve pubkeys.

    The success shape is byte-compatible with the reference; failures add
    result_type/error_reason (the reference publishes NOTHING on keygen
    failure and clients wait forever — a wart not worth reproducing)."""

    wallet_id: str
    ecdsa_pub_key: str  # hex (SEC1 compressed; reference emits raw X||Y)
    eddsa_pub_key: str  # hex (compressed Edwards)
    result_type: str = RESULT_SUCCESS
    error_reason: str = ""
    retryable: bool = False
    v: int = 0

    def to_json(self) -> Dict[str, Any]:
        out = {
            "wallet_id": self.wallet_id,
            "ecdsa_pub_key": self.ecdsa_pub_key,
            "eddsa_pub_key": self.eddsa_pub_key,
        }
        if self.result_type != RESULT_SUCCESS:
            out["result_type"] = self.result_type
            out["error_reason"] = self.error_reason
            if self.retryable:
                out["retryable"] = True
        if self.v:
            out["v"] = self.v
        return out

    @classmethod
    def from_json(cls, d) -> "KeygenSuccessEvent":
        return cls(
            wallet_id=d["wallet_id"],
            ecdsa_pub_key=d.get("ecdsa_pub_key", ""),
            eddsa_pub_key=d.get("eddsa_pub_key", ""),
            result_type=d.get("result_type", RESULT_SUCCESS),
            error_reason=d.get("error_reason", ""),
            retryable=bool(d.get("retryable", False)),
            v=int(d.get("v", 0)),
        )


@dataclass
class SigningResultEvent:
    """reference event.SigningResultEvent (event/sign.go:21-34)."""

    result_type: str  # success | error
    wallet_id: str
    tx_id: str
    network_internal_code: str = ""
    error_reason: str = ""
    is_timeout: bool = False
    r: str = ""  # hex, ECDSA
    s: str = ""  # hex, ECDSA
    signature_recovery: str = ""  # hex byte, ECDSA
    signature: str = ""  # hex, EdDSA (64-byte R||s)
    # honest shedding: True ⇒ the request was refused before protocol work
    # (backpressure, deadline expiry) and a verbatim retry is safe. Omitted
    # from JSON when False so the reference-pinned success shape is unchanged.
    retryable: bool = False
    v: int = 0

    def to_json(self) -> Dict[str, Any]:
        out = {
            "result_type": self.result_type,
            "error_reason": self.error_reason,
            "is_timeout": self.is_timeout,
            "network_internal_code": self.network_internal_code,
            "wallet_id": self.wallet_id,
            "tx_id": self.tx_id,
            "r": self.r,
            "s": self.s,
            "signature_recovery": self.signature_recovery,
            "signature": self.signature,
        }
        if self.retryable:
            out["retryable"] = True
        if self.v:
            out["v"] = self.v
        return out

    @classmethod
    def from_json(cls, d) -> "SigningResultEvent":
        return cls(
            result_type=d["result_type"],
            wallet_id=d["wallet_id"],
            tx_id=d["tx_id"],
            network_internal_code=d.get("network_internal_code", ""),
            error_reason=d.get("error_reason", ""),
            is_timeout=bool(d.get("is_timeout", False)),
            r=d.get("r", ""),
            s=d.get("s", ""),
            signature_recovery=d.get("signature_recovery", ""),
            signature=d.get("signature", ""),
            retryable=bool(d.get("retryable", False)),
            v=int(d.get("v", 0)),
        )


@dataclass
class ResharingSuccessEvent:
    """reference mpc.ResharingSuccessEvent (ecdsa_resharing_session.go:40-44),
    plus an error shape (result_type/error_reason) for terminal failures."""

    wallet_id: str
    new_threshold: int
    key_type: str
    pub_key: str  # hex
    result_type: str = RESULT_SUCCESS
    error_reason: str = ""
    retryable: bool = False
    v: int = 0

    def to_json(self) -> Dict[str, Any]:
        out = {
            "wallet_id": self.wallet_id,
            "new_threshold": self.new_threshold,
            "key_type": self.key_type,
            "pub_key": self.pub_key,
        }
        if self.result_type != RESULT_SUCCESS:
            out["result_type"] = self.result_type
            out["error_reason"] = self.error_reason
            if self.retryable:
                out["retryable"] = True
        if self.v:
            out["v"] = self.v
        return out

    @classmethod
    def from_json(cls, d) -> "ResharingSuccessEvent":
        return cls(
            wallet_id=d["wallet_id"],
            new_threshold=int(d["new_threshold"]),
            key_type=d["key_type"],
            pub_key=d.get("pub_key", ""),
            result_type=d.get("result_type", RESULT_SUCCESS),
            error_reason=d.get("error_reason", ""),
            retryable=bool(d.get("retryable", False)),
            v=int(d.get("v", 0)),
        )


# ---------------------------------------------------------------------------
# topics (reference event_consumer.go:24-27, event/sign.go:3-11,
# pkg/mpc/session.go:40-43)
# ---------------------------------------------------------------------------

TOPIC_GENERATE = "mpc:generate"
TOPIC_SIGN = "mpc:sign"
TOPIC_RESHARE = "mpc:reshare"
TOPIC_SIGNING_REQUEST = "mpc.signing_request.event"
TOPIC_KEYGEN_RESULT = "mpc.mpc_keygen_success"
TOPIC_SIGNING_RESULT = "mpc.signing_result.complete"
TOPIC_RESHARING_RESULT = "mpc.mpc_resharing_success"
# batched-signing manifest fan-out (the batch scheduler; no reference
# analogue - the reference runs one goroutine per session)
TOPIC_BATCH_MANIFEST = "mpc:batch_manifest"


def keygen_broadcast_topic(key_type: str, wallet_id: str) -> str:
    return f"keygen:broadcast:{_kt(key_type)}:{wallet_id}"


def keygen_direct_topic(key_type: str, node_id: str, wallet_id: str) -> str:
    return f"keygen:direct:{_kt(key_type)}:{node_id}:{wallet_id}"


def sign_broadcast_topic(key_type: str, wallet_id: str, tx_id: str) -> str:
    return f"sign:{_kt(key_type)}:broadcast:{wallet_id}:{tx_id}"


def sign_direct_topic(key_type: str, node_id: str, tx_id: str) -> str:
    return f"sign:{_kt(key_type)}:direct:{node_id}:{tx_id}"


def resharing_broadcast_topic(key_type: str, wallet_id: str) -> str:
    return f"resharing:broadcast:{_kt(key_type)}:{wallet_id}"


def resharing_direct_topic(key_type: str, node_id: str, wallet_id: str) -> str:
    return f"resharing:direct:{_kt(key_type)}:{node_id}:{wallet_id}"


def _kt(key_type: str) -> str:
    """Reference uses 'ecdsa'/'eddsa' in topic segments."""
    return {"secp256k1": "ecdsa", "ed25519": "eddsa"}.get(key_type, key_type)
