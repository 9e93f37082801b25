"""Network-reachable control-plane KV served by the message broker.

The reference's control plane (registry liveness, keyinfo, peers) is
Consul over HTTP(S)+ACL, reachable from separate machines
(reference pkg/infra/consul.go:19-47, cmd/mpcium/main.go:302-311).
The FileKV equivalent only spans hosts via a shared volume — unusable
for MPC's actual deployment model of mutually-distrusting operators on
separate machines. Here the broker — already the cluster's network
rendezvous, with token auth, an AEAD channel, journal durability and
hot-standby replication — serves the same KV surface over its socket
(transport/tcp.py kvput/kvget/kvdel/kvkeys ops).

Durable keys (keyinfo, peers) are fsync-journaled on the broker and
replicated to standbys; liveness heartbeats use :meth:`put_transient`
(neither journaled nor replicated — after a failover each node's 1 Hz
heartbeat loop repopulates them within a poll period).

Select with ``control_plane: broker`` in config.yaml; nodes then share
ONLY broker addresses — no common filesystem.
"""
from __future__ import annotations

from typing import List, Optional

from .kvstore import KVStore


class BrokerKV(KVStore):
    def __init__(self, client, timeout_s: float = 10.0):
        self._cli = client  # transport.tcp.TcpClient
        self._timeout_s = timeout_s

    def put(self, key: str, value: bytes) -> None:
        self._cli.kv_request(
            {"op": "kvput", "k": key, "v": value.hex()}, self._timeout_s
        )

    def put_transient(self, key: str, value: bytes) -> None:
        """Best-effort, non-durable put (liveness heartbeats): not
        journaled, not replicated to standbys."""
        self._cli.kv_request(
            {"op": "kvput", "k": key, "v": value.hex(), "t": 1},
            self._timeout_s,
        )

    def get(self, key: str) -> Optional[bytes]:
        r = self._cli.kv_request(
            {"op": "kvget", "k": key}, self._timeout_s
        )
        v = r.get("v")
        return None if v is None else bytes.fromhex(v)

    def delete(self, key: str) -> None:
        self._cli.kv_request(
            {"op": "kvdel", "k": key}, self._timeout_s
        )

    def keys(self, prefix: str = "") -> List[str]:
        r = self._cli.kv_request(
            {"op": "kvkeys", "p": prefix}, self._timeout_s
        )
        return list(r.get("keys") or [])

    def scan(self, prefix: str = "") -> dict:
        """Prefix scan in ONE round-trip: {key: value-bytes}. The
        registry's 1 Hz liveness poll uses this instead of keys() +
        per-key get() (O(N) network RTTs per poll otherwise)."""
        r = self._cli.kv_request(
            {"op": "kvscan", "p": prefix}, self._timeout_s
        )
        return {
            k: bytes.fromhex(v) for k, v in (r.get("items") or {}).items()
        }
