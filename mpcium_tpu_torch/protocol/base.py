"""Protocol records the signing slice needs: the durable keygen share and
the Shamir x-coordinate map (the port's copies of the JAX package's
``protocol/base.py`` definitions, same JSON form)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence


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
