"""Config system (the viper analogue, reference pkg/config; the port's
copy of the JAX package's ``config.py``).

`config.yaml` in the working directory (or an explicit path), with
environment-variable overrides: ``MPCIUM_<KEY>`` where ``.`` → ``_``
(reference init.go:48-61, e.g. ``MPCIUM_MPC_THRESHOLD=2``)."""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any, Dict, Optional


@dataclass
class AppConfig:
    """The settings the port's node reads: the JAX package's fields of the
    same names (its daemon-only fields — stores, identities, broker,
    warm start — come with the daemon, ROADMAP queue 1 item 5; a config
    file that sets them still loads, they are ignored)."""

    mpc_threshold: int = 2
    batch_window_s: float = 0.05
    # SLO-aware continuous batching (consumers/batch_scheduler.py)
    batch_max_batch: int = 1024  # dispatch at this many entries OR window age
    batch_manifest_timeout_s: float = 2.0  # deputy takeover at T, fallback 2T
    batch_patience_s: float = 900.0  # decline-responder / covered-entry TTL
    batch_deadline_ms: int = 30000  # default per-request deadline budget
    batch_max_queue_depth: int = 100000  # intake bound; over-depth submits shed
    batch_decline_cap: int = 64  # concurrent decline responders (oldest evicted)


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
