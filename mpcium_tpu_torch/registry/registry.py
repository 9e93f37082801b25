"""Peer registry / liveness (the Consul `ready/` analogue, pkg/mpc/registry.go).

`ready(node)` writes ``ready/<nodeID>``; a watcher polls the listing at the
reference's 1 Hz (registry.go:16), maintains the ready map/count, logs
connect/disconnect transitions, and flips cluster-ready when everyone is
present (registry.go:68-89). `resign()` removes the key on shutdown
(registry.go:198-207)."""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set

from ..store.kvstore import KVStore
from ..utils import log

READY_PREFIX = "ready/"
DEFAULT_POLL_S = 1.0  # reference registry.go:16
# First-sight tolerance: a key we have never observed change counts as
# live only while its self-reported wall stamp is within this bound of
# our clock (covers realistic cross-host skew; a SIGKILLed peer's old
# corpse key is rejected immediately, a fresh one goes dead after one
# staleness window because its value never changes). Ongoing liveness is
# purely change-based and never compares clocks.
COARSE_SKEW_S = 300.0


class PeerRegistry:
    """Reference mpc.PeerRegistry (registry.go:19-27)."""

    def __init__(
        self,
        node_id: str,
        peer_ids: List[str],
        kv: KVStore,
        poll_interval_s: float = DEFAULT_POLL_S,
    ):
        self.node_id = node_id
        self.peer_ids = sorted(set(peer_ids) | {node_id})
        self.kv = kv
        self.poll_interval_s = poll_interval_s
        self._ready_map: Set[str] = set()
        self._cluster_ready = False
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # local desired-state: heartbeats follow THIS flag, not the KV's
        # current contents — liveness keys are transient on the broker
        # control plane, so after a broker failover the key is absent on
        # the standby and a KV-presence check would silently stop
        # re-registering forever
        self._registered = False
        # pid -> (last heartbeat value, LOCAL monotonic time it changed,
        # confirmed): liveness is judged by whether a peer's heartbeat
        # value keeps CHANGING, on this observer's clock — remote wall
        # clocks are never compared against ours (cross-host skew > the
        # 5 s budget would mark healthy peers dead forever), and a key
        # merely EXISTING proves nothing (a SIGKILLed peer's stale key
        # persists; "confirmed" flips only once a change is observed)
        self._hb_seen: Dict[str, tuple] = {}

    # -- lifecycle ----------------------------------------------------------

    def ready(self) -> None:
        """Announce readiness (registry.go:93-107). The value carries a
        heartbeat timestamp; the watch loop refreshes it each tick and
        watchers treat stale entries as dead — so a SIGKILLed node that
        never ran resign() falls out of quorum instead of poisoning every
        future session (Consul achieves this with session TTLs)."""
        self._registered = True
        self._heartbeat()
        self._poll_once()

    def _heartbeat(self) -> None:
        # liveness entries are transient on KV backends that distinguish
        # (BrokerKV: no journal/replication churn at 1 Hz x N nodes)
        put = getattr(self.kv, "put_transient", self.kv.put)
        put(READY_PREFIX + self.node_id, str(time.time()).encode())

    def resign(self) -> None:
        """De-register on shutdown (registry.go:198-207)."""
        self._registered = False
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.poll_interval_s + 1)
        self.kv.delete(READY_PREFIX + self.node_id)

    def watch(self) -> None:
        """Start the background poll loop (registry.go:109-146)."""
        if self._thread:
            return
        self._thread = threading.Thread(
            target=self._watch_loop, name=f"registry-{self.node_id}", daemon=True
        )
        self._thread.start()

    # -- queries (registry.go:157-196) --------------------------------------

    def ready_count(self) -> int:
        with self._lock:
            return len(self._ready_map)

    def ready_peers(self) -> List[str]:
        with self._lock:
            return sorted(self._ready_map)

    def is_peer_ready(self, peer_id: str) -> bool:
        with self._lock:
            return peer_id in self._ready_map

    def all_ready(self) -> bool:
        with self._lock:
            return self._cluster_ready

    def wait_all_ready(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self._poll_once()
            if self.all_ready():
                return True
            time.sleep(min(self.poll_interval_s, 0.05))
        return False

    # -- internals ----------------------------------------------------------

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            # a KV error (broker failover window on the network control
            # plane) must not kill the watch thread: a dead loop would
            # silently stop heartbeating forever and every peer would
            # mark this node dead until a process restart
            try:
                if self._registered:
                    self._heartbeat()  # refresh own TTL while registered
                self._poll_once()
            except Exception as e:  # noqa: BLE001
                log.warn("registry poll failed; retrying",
                         node=self.node_id, error=repr(e))

    def _stale_after_s(self) -> float:
        # a peer missing 5 heartbeat periods (min 3 s) is dead
        return max(5 * self.poll_interval_s, 3.0)

    @staticmethod
    def _coarse_fresh(raw: bytes) -> bool:
        try:
            ts = float(raw)
        except (TypeError, ValueError):
            return False  # legacy "true" values: must be seen to change
        return abs(time.time() - ts) <= COARSE_SKEW_S

    def _poll_once(self) -> None:
        stale_after = self._stale_after_s()
        local_now = time.monotonic()
        now = set()
        seen_pids = set()
        # one network round-trip when the KV supports prefix scans
        # (BrokerKV); keys()+get() per peer otherwise (FileKV/MemoryKV)
        scan = getattr(self.kv, "scan", None)
        if scan is not None:
            entries = scan(READY_PREFIX).items()
        else:
            entries = [
                (k, self.kv.get(k)) for k in self.kv.keys(READY_PREFIX)
            ]
        for k, raw in entries:
            pid = k[len(READY_PREFIX):]
            if pid not in self.peer_ids or raw is None:
                continue
            seen_pids.add(pid)
            if pid == self.node_id:
                # our own registration needs no cross-checking
                if self._registered:
                    now.add(pid)
                continue
            prev = self._hb_seen.get(pid)
            if prev is None:
                # first sight: benefit of the doubt only within the
                # coarse skew bound (see COARSE_SKEW_S); confirmation —
                # and all ongoing liveness — comes from observing the
                # value CHANGE on our own clock
                self._hb_seen[pid] = (raw, local_now, False)
                if self._coarse_fresh(raw):
                    now.add(pid)
            elif prev[0] != raw:
                self._hb_seen[pid] = (raw, local_now, True)
                now.add(pid)
            elif local_now - prev[1] <= stale_after and (
                prev[2] or self._coarse_fresh(raw)
            ):
                now.add(pid)
        # explicit resign (key deleted) forgets the peer immediately
        for pid in list(self._hb_seen):
            if pid not in seen_pids:
                del self._hb_seen[pid]
        with self._lock:
            joined = now - self._ready_map
            left = self._ready_map - now
            self._ready_map = now
            was_ready = self._cluster_ready
            self._cluster_ready = now == set(self.peer_ids)
        for p in sorted(joined):
            log.info("peer ready", peer=p, node=self.node_id)
        for p in sorted(left):
            log.warn("peer disconnected!", peer=p, node=self.node_id)  # registry.go:135
        if self._cluster_ready and not was_ready:
            log.info("ALL PEERS ARE READY", node=self.node_id)  # registry.go:86
