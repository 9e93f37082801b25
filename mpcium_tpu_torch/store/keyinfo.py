"""Wallet metadata store (the Consul keyinfo analogue, pkg/keyinfo).

`KeyInfo{participant_peer_ids, threshold, is_reshared}` at
``threshold_keyinfo/<ecdsa|eddsa>:<walletID>`` (keyinfo.go:11-15,67-68),
extended with the public key + aggregated VSS commitments so that NEW
resharing committee members can verify the redeal binding without holding
an old share (protocol/resharing.py needs old_vss_commitments)."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from .kvstore import KVStore

PREFIX = "threshold_keyinfo/"


@dataclass
class KeyInfo:
    participant_peer_ids: List[str]
    threshold: int
    is_reshared: bool = False
    public_key: str = ""  # hex compressed
    vss_commitments: List[str] = field(default_factory=list)  # hex
    # resharing generation (see protocol.base.KeygenShare.epoch): signing is
    # fenced on keyinfo.epoch == share.epoch
    epoch: int = 0

    def to_json(self) -> dict:
        return {
            "participant_peer_ids": self.participant_peer_ids,
            "threshold": self.threshold,
            "is_reshared": self.is_reshared,
            "public_key": self.public_key,
            "vss_commitments": self.vss_commitments,
            "epoch": self.epoch,
        }

    @classmethod
    def from_json(cls, d: dict) -> "KeyInfo":
        return cls(
            participant_peer_ids=list(d["participant_peer_ids"]),
            threshold=int(d["threshold"]),
            is_reshared=bool(d.get("is_reshared", False)),
            public_key=d.get("public_key", ""),
            vss_commitments=list(d.get("vss_commitments", [])),
            epoch=int(d.get("epoch", 0)),
        )


class KeyinfoStore:
    """Reference keyinfo.Store (Get/Save, keyinfo.go:25-28)."""

    def __init__(self, kv: KVStore):
        self.kv = kv

    @staticmethod
    def _key(key_type: str, wallet_id: str) -> str:
        kt = {"secp256k1": "ecdsa", "ed25519": "eddsa"}.get(key_type, key_type)
        return f"{PREFIX}{kt}:{wallet_id}"

    def save(self, key_type: str, wallet_id: str, info: KeyInfo) -> None:
        self.kv.put(self._key(key_type, wallet_id), json.dumps(info.to_json()).encode())

    def get(self, key_type: str, wallet_id: str) -> Optional[KeyInfo]:
        raw = self.kv.get(self._key(key_type, wallet_id))
        return KeyInfo.from_json(json.loads(raw)) if raw else None
