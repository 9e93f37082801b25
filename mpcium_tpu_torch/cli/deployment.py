"""A local deployment of the port: a broker and ``n`` node daemons, each a
process of its own started through the port's CLIs, in a workspace that
the ops CLI bootstraps (the steps an operator runs by hand, as README's
"mpcium-tpu-torch broker … mpcium-tpu-torch start -n node0").

    dep = Deployment(Path("work"), dev="cpu", cfg={"batch_window_s": 2.0})
    dep.start()              # bootstrap, broker, daemons; wait for readiness
    rc = dep.remote()        # a RemoteCluster on the same broker
    ...
    rc.close(); dep.stop()   # SIGTERM every daemon, then the broker

``chip_smoke.py`` runs its phase 25 on it and the daemon tests run it
with ``dev="cpu"``.
"""
from __future__ import annotations

import json
import os
import secrets
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

# the directory that holds the package: the daemons import it from there
SRC_ROOT = Path(__file__).resolve().parents[2]
SAFE_PRIMES = SRC_ROOT / "mpcium_tpu_torch" / "data" / "safeprimes_1024.json"


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Deployment:
    """A broker and ``n`` node daemons, each a process of its own started
    through the port's CLIs (``python -m mpcium_tpu_torch.cli.main``), in
    a workspace bootstrapped by the port's ops CLI: ``generate-peers``,
    ``register-peers`` into the broker's control plane,
    ``generate-identity`` per node and ``generate-initiator``. Every node
    has a directory of its own (identity, safe-prime pool, config.yaml
    with ``control_plane: broker``, ``broker_encrypt: true``); the token
    rides ``MPCIUM_BROKER_TOKEN``. ``dev`` None starts the daemons on
    their default device (the GPU); else ``--device dev``. ``cfg`` adds
    config keys."""

    def __init__(self, root: Path, n: int = 3, dev=None, cfg=None):
        self.root = Path(root)
        self.nodes = [f"node{i}" for i in range(n)]
        self.dev = dev
        self.cfg = dict(cfg or {})
        self.token = secrets.token_hex(16)
        self.port = free_port()
        self.staging = self.root / "staging"
        self.env = dict(os.environ, MPCIUM_BROKER_TOKEN=self.token, PYTHONPATH=os.pathsep.join(
            [str(SRC_ROOT)] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
        self.procs = {}
        self._logs = {}

    def _ops(self, *args) -> None:
        r = subprocess.run([sys.executable, "-m", "mpcium_tpu_torch.cli.ops", *args],
                           cwd=self.staging, env=self.env, capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"ops CLI {args[0]} failed: {r.stdout[-1500:]}{r.stderr[-1500:]}")

    def _spawn(self, tag: str, cwd: Path, *args) -> None:
        self._logs[tag] = open(self.root / f"{tag}.log", "wb")
        self.procs[tag] = subprocess.Popen(
            [sys.executable, "-m", "mpcium_tpu_torch.cli.main", *args],
            cwd=cwd, env=self.env, stdout=self._logs[tag], stderr=subprocess.STDOUT)

    def log_tail(self, tag: str, n: int = 2000) -> str:
        p = self.root / f"{tag}.log"
        return p.read_text(errors="replace")[-n:] if p.exists() else ""

    def _alive(self, what: str) -> None:
        dead = {tag: p.returncode for tag, p in self.procs.items() if p.poll() is not None}
        if dead:
            raise RuntimeError(f"deployment {what}: processes exited {dead}: " + " | ".join(
                f"{tag}: {self.log_tail(tag)}" for tag in dead))

    def config_text(self, pool: Path, extra: dict) -> str:
        lines = {"mpc_threshold": 1, "control_plane": "broker",
                 "event_initiator_pubkey": self.initiator_pub,
                 "badger_password": f"store-{self.token}", "broker_port": self.port,
                 "broker_encrypt": True, "broker_journal": str(self.root / "broker" / "journal.jsonl"),
                 "safe_prime_pool": str(pool), "batch_signing": True, **extra}
        return "".join(f"{k}: {json.dumps(v)}\n" for k, v in lines.items())

    def start(self, t_limit: float = 300.0) -> dict:
        """Bootstrap, start the broker and the daemons, and wait until every
        node has seen all its peers and finished its boot (its warm pass
        included) → seconds per step."""
        t0 = time.perf_counter()
        self.staging.mkdir(parents=True)
        (self.root / "broker").mkdir()
        self._ops("generate-peers", "-n", str(len(self.nodes)))
        self._spawn("broker", self.root / "broker", "broker", "--port", str(self.port),
                    "--journal", str(self.root / "broker" / "journal.jsonl"), "--encrypt")
        while True:
            try:
                socket.create_connection(("127.0.0.1", self.port), timeout=1).close()
                break
            except OSError:
                self._alive("broker start")
                if time.perf_counter() - t0 > 60:
                    raise RuntimeError("deployment: the broker never opened its port")
                time.sleep(0.1)
        self._ops("register-peers", "--broker", f"127.0.0.1:{self.port}",
                  "--broker-token", self.token, "--broker-encrypt")
        for nid in self.nodes:
            self._ops("generate-identity", "--node", nid)
        self._ops("generate-initiator")
        self.initiator_pub = json.loads((self.staging / "event_initiator.json").read_text())[
            "public_key"]
        boot_s = time.perf_counter() - t0
        pool = SAFE_PRIMES
        for nid in self.nodes:
            nd = self.root / nid
            shutil.copytree(self.staging / "identity", nd / "identity")
            shutil.copy(pool, nd / "safeprimes.json")  # pool_take consumes entries
            (nd / "config.yaml").write_text(self.config_text(nd / "safeprimes.json", self.cfg))
            self._spawn(nid, nd, "start", "-n", nid,
                        *(() if self.dev is None else ("--device", str(self.dev))))
        # the client's config: the same endpoint and channel, next to its key
        (self.staging / "config.yaml").write_text(self.config_text(pool, {}))
        while not all(b"ALL PEERS ARE READY" in log and b"node running" in log
                      for log in ((self.root / f"{nid}.log").read_bytes()
                                  for nid in self.nodes)):
            self._alive("start")
            if time.perf_counter() - t0 > t_limit:
                raise RuntimeError("deployment: the nodes never saw all their peers: "
                                     + " | ".join(self.log_tail(n, 800) for n in self.nodes))
            time.sleep(0.2)
        return {"bootstrap_s": boot_s, "ready_s": time.perf_counter() - t0}

    def remote(self):
        """A ``RemoteCluster`` on the staging config (token from the
        environment, as the daemons take it)."""
        from ..cluster import RemoteCluster

        old = os.environ.get("MPCIUM_BROKER_TOKEN")
        os.environ["MPCIUM_BROKER_TOKEN"] = self.token
        try:
            return RemoteCluster(str(self.staging / "config.yaml"))
        finally:
            if old is None:
                del os.environ["MPCIUM_BROKER_TOKEN"]
            else:
                os.environ["MPCIUM_BROKER_TOKEN"] = old

    def health(self, kv, after: float, t_limit: float = 180.0) -> dict:
        """Every node's ``health/<node>`` beat published after ``after``
        (wall clock) by a node with no live session and no request claim
        → snapshots by node."""
        t0 = time.perf_counter()
        while True:
            snaps = {nid: json.loads(kv.get(f"health/{nid}") or b"{}") for nid in self.nodes}
            if all(s.get("ts", 0) > after and not s["live_sessions"] and not s["dedup_claims"]
                   for s in snaps.values()):
                return snaps
            self._alive("health")
            if time.perf_counter() - t0 > t_limit:
                raise RuntimeError(f"deployment: no settled health beat in {t_limit} s: "
                                     f"{ {n: (s.get('ts'), s.get('live_sessions'), s.get('dedup_claims')) for n, s in snaps.items()} }")
            time.sleep(0.5)

    def stop(self, t_limit: float = 30.0) -> dict:
        """SIGTERM every daemon, then the broker; each must exit 0 within
        ``t_limit`` s → (exit code, seconds) by process (killed: None)."""
        out = {}
        for tag in self.nodes + ["broker"]:
            p = self.procs.get(tag)
            if p is None:
                continue
            t0 = time.perf_counter()
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
            try:
                out[tag] = (p.wait(t_limit), time.perf_counter() - t0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                out[tag] = (None, time.perf_counter() - t0)
        for f in self._logs.values():
            f.close()
        return out
