"""Config system (the viper analogue, reference pkg/config; the port's
copy of the JAX package's ``config.py``).

`config.yaml` in the working directory (or an explicit path), with
environment-variable overrides: ``MPCIUM_<KEY>`` where ``.`` → ``_``
(reference init.go:48-61, e.g. ``MPCIUM_MPC_THRESHOLD=2``). Secrets are
masked in serialized dumps (init.go:21-33).

The fields, names and defaults are the JAX package's, plus one:
``reply_timeout_s``, the signing bridge's reply wait (the JAX daemon
fixes it at ``consumers/signing_consumer.REPLY_TIMEOUT_S``, 30 s, which a
full-width GG18 batch on the card outlasts)."""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any, Dict, Optional

_SECRET_KEYS = {"badger_password", "passphrase", "broker_token"}


@dataclass
class AppConfig:
    mpc_threshold: int = 2
    environment: str = "development"
    event_initiator_pubkey: str = ""  # hex
    badger_password: str = ""
    identity_dir: str = "identity"
    db_dir: str = "./db"
    control_kv_dir: str = "./control"  # FileKV root (the Consul analogue)
    # "file": FileKV directory (single-host dev; needs a shared volume for
    # multi-process). "broker": KV served by the broker over the network —
    # nodes share ONLY broker addresses, the multi-host deployment model
    # (reference serves this via Consul HTTP(S), consul.go:19-47)
    control_plane: str = "file"
    safe_prime_pool: str = ""
    passphrase: str = ""  # identity decryption (or prompt)
    broker_host: str = "127.0.0.1"  # TCP bus (the NATS analogue)
    broker_port: int = 4333
    broker_token: str = ""  # shared auth token (reference NATS credentials)
    broker_encrypt: bool = False  # AEAD channel (reference prod TLS posture)
    broker_journal: str = ""  # queue journal path ("" = in-memory queues)
    broker_standbys: str = ""  # failover endpoints, "host:port[,host:port]"
    batch_signing: bool = False  # batch scheduler: batched parties on the device
    batch_window_s: float = 0.05
    # SLO-aware continuous batching (consumers/batch_scheduler.py)
    batch_max_batch: int = 1024  # dispatch at this many entries OR window age
    batch_manifest_timeout_s: float = 2.0  # deputy takeover at T, fallback 2T
    batch_patience_s: float = 900.0  # decline-responder / covered-entry TTL
    batch_deadline_ms: int = 30000  # default per-request deadline budget
    batch_max_queue_depth: int = 100000  # intake bound; over-depth submits shed
    batch_decline_cap: int = 64  # concurrent decline responders (oldest evicted)
    # the signing bridge's reply wait (port only; JAX fixes 30 s): a
    # request holds its queue delivery until its batch answers
    reply_timeout_s: float = 30.0
    chaos_fault_plan: str = ""  # path to a faults.FaultPlan JSON ("" = off)
    session_wal: bool = False  # encrypted per-round session WAL + crash resume
    peers_file: str = "peers.json"
    # warm-start pass (warm/prewarm.prewarm_for_daemon): the daemon runs
    # the serving buckets on its device before it reports ready
    warm_enabled: bool = False
    warm_budget_s: float = 300.0  # boot stays "warming" at most this long
    warm_schemes: str = "eddsa"  # comma list of eddsa,ecdsa,dkg,reshare ("" = all)
    warm_max_b: int = 64  # largest batch bucket to pre-warm
    warm_cache_dir: str = ""  # "" = <db_dir>/<node>/warm_cache_<hostfp>

    def to_json(self, mask_secrets: bool = True) -> Dict[str, Any]:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if mask_secrets and f.name in _SECRET_KEYS and v:
                v = "********"
            out[f.name] = v
        return out


_config: Optional[AppConfig] = None
_lock = threading.Lock()


def init_config(path: Optional[str] = None, **overrides) -> AppConfig:
    """Load config.yaml + env overrides + explicit overrides."""
    global _config
    data: Dict[str, Any] = {}
    cfg_path = Path(path) if path else Path("config.yaml")
    if cfg_path.exists():
        # lazy, and only for a file that exists: a cluster built from
        # arguments alone needs no YAML parser on the host
        import yaml

        data.update(yaml.safe_load(cfg_path.read_text()) or {})
    def _coerce(current, raw):
        # bool("false") is True — parse the usual spellings explicitly
        if isinstance(current, bool) and isinstance(raw, str):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return type(current)(raw)

    cfg = AppConfig()
    for f in fields(AppConfig):
        if f.name in data:
            setattr(cfg, f.name, _coerce(getattr(cfg, f.name), data[f.name]))
        env = os.environ.get("MPCIUM_" + f.name.upper().replace(".", "_"))
        if env is not None:
            setattr(cfg, f.name, _coerce(getattr(cfg, f.name), env))
    for k, v in overrides.items():
        if v is not None:
            setattr(cfg, k, v)
    with _lock:
        _config = cfg
    return cfg


def get_config() -> AppConfig:
    global _config
    with _lock:
        if _config is None:
            _config = AppConfig()
        return _config


def check_required(cfg: AppConfig, keys) -> None:
    """Reference checkRequiredConfigValues (main.go:278-288)."""
    missing = [k for k in keys if not getattr(cfg, k, None)]
    if missing:
        raise SystemExit(
            f"missing required config values: {', '.join(missing)} "
            f"(set in config.yaml or MPCIUM_<KEY> env)"
        )
