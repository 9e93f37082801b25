"""The warm work-list: every (engine, shape) bucket a node will serve.

The port's copy of ``mpcium_tpu/warm/manifest.py``. The JAX package
reads its serving templates from ``COMPILE_SURFACE.json`` (written by its
shape analysis, ``mpcshape``); the port has neither and compiles nothing
per shape, so it keeps the seven *serving* templates of that surface as
data (:data:`SERVING_TEMPLATES`). ``party.eddsa`` is not among them, as
in the surface. Instantiated, they give the concrete list:

- the batch dimension ``B`` ranges over ``engine/buckets.BUCKETS`` (the
  scheduler drains pow-2 chunks, so these are the only B values the
  engines are ever handed);
- every other dimension (quorum size, key type, MtA backend, new
  threshold) is a knob with values from :class:`WarmKnobs`, derived from
  config; a knob with no configured values is a **gap**, reported in the
  manifest, never silently skipped;
- entries are ordered hot-first by observed traffic (the port's
  ``COMPILE_LEDGER.json``), then cheap-first (small B), so a budget-cut
  pass covers the most value.

The manifest is keyed by the ``perf/envfp.py`` host fingerprint plus
the torch and CUDA versions (where the JAX key has jax and jaxlib): a key
mismatch says the warm state was made elsewhere (``key_matches``).

Pure stdlib on purpose, like ``engine/buckets``: building or checking a
manifest never imports torch.
"""
from __future__ import annotations

import itertools
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..engine.buckets import BUCKETS
from ..perf import envfp

REPORT_BASENAME = "WARM_MANIFEST.json"  # the prewarm report, in the warm dir

# engine → scheme family: ``warm_schemes`` selects families, and the
# party-level protocol engines ride along with their scheme
ENGINE_SCHEME = {
    "eddsa.sign": "eddsa",
    "gg18.sign": "ecdsa",
    "party.ecdsa": "ecdsa",
    "party.eddsa": "eddsa",
    "dkg.run": "dkg",
    "party.dkg": "dkg",
    "reshare.run": "reshare",
    "party.reshare": "reshare",
}

ALL_SCHEMES = ("eddsa", "ecdsa", "dkg", "reshare")

# the serving templates of the JAX package's COMPILE_SURFACE.json (its
# records with ``serving: true``): ``{B}`` is the batch bucket, every
# other ``{name}`` a knob of WarmKnobs
SERVING_TEMPLATES: Dict[str, str] = {
    "dkg.run": "B{B}|q{q}|{key_type}",
    "eddsa.sign": "B{B}|q{q}",
    "gg18.sign": "B{B}|q{q}|mta={mta_impl}",
    "party.dkg": "B{B}|q{q}|{key_type}",
    "party.ecdsa": "B{B}|q{q}",
    "party.reshare": "B{B}|q{q}|{key_type}|t{t_new}",
    "reshare.run": "B{B}|{key_type}|t{t_new}",
}

_DIM_RE = re.compile(r"\{([^{}]*)\}")


@dataclass(frozen=True)
class WarmKnobs:
    """Concrete values for every knob dimension. Finite by construction:
    these are configuration, not traffic."""

    q: Tuple[int, ...] = (2,)
    key_type: Tuple[str, ...] = ("ed25519", "secp256k1")
    mta_impl: Tuple[str, ...] = ("paillier", "ot")
    t_new: Tuple[int, ...] = (1,)

    def values_for(self, name: str) -> Tuple[str, ...]:
        vals = getattr(self, name, ())
        return tuple(str(v) for v in vals)

    def to_json(self) -> Dict[str, list]:
        return {
            "q": list(self.q),
            "key_type": list(self.key_type),
            "mta_impl": list(self.mta_impl),
            "t_new": list(self.t_new),
        }


def default_knobs(threshold: Optional[int] = None) -> WarmKnobs:
    """Knob values for a t-of-n deployment: the serving quorum is t+1 and
    reshares rotate to the same threshold. The MtA backend axis is what
    this process would serve (``MPCIUM_MTA``) plus ``ot``, so a node can
    flip to the checked backend warm."""
    t = 1 if threshold is None else int(threshold)
    if t < 1:
        raise ValueError(f"need threshold >= 1, got {t}")
    mta = os.environ.get("MPCIUM_MTA", "paillier")
    return WarmKnobs(
        q=(t + 1,),
        mta_impl=(mta,) if mta == "ot" else (mta, "ot"),
        t_new=(t,),
    )


def knobs_from_config(cfg) -> WarmKnobs:
    return default_knobs(threshold=cfg.mpc_threshold)


# -- the environment key -----------------------------------------------------


def manifest_key() -> Dict[str, Optional[str]]:
    """What the warm state depends on: the host CPU feature set and the
    torch build with its CUDA toolkit."""
    return {
        "host": envfp.host_fingerprint(),
        "torch": envfp.torch_version(),
        "cuda": envfp.cuda_version(),
    }


def key_matches(stored: Optional[Dict[str, object]],
                current: Optional[Dict[str, object]] = None
                ) -> Tuple[bool, str]:
    """(ok, reason). A stale key means the warm state was made under
    another host or toolchain and is not trusted."""
    if current is None:
        current = manifest_key()
    if not isinstance(stored, dict):
        return False, "no environment key stored"
    for k in ("host", "torch", "cuda"):
        if stored.get(k) != current.get(k):
            return False, (
                f"{k} changed: {stored.get(k)!r} -> {current.get(k)!r}"
            )
    return True, "ok"


# -- traffic priority --------------------------------------------------------


def traffic_weights(ledger_entries: Sequence[dict] = (),
                    history_records: Sequence[dict] = ()
                    ) -> Dict[Tuple[str, str], float]:
    """Observed-traffic weight per (engine, shape). Ledger entries are
    exact signatures (weight 1 each); bench history records vote for
    their scheme's engines at the recorded batch bucket."""
    w: Dict[Tuple[str, str], float] = {}
    for e in ledger_entries:
        eng, shape = e.get("engine"), e.get("shape")
        if isinstance(eng, str) and isinstance(shape, str):
            k = (eng, shape)
            w[k] = w.get(k, 0.0) + 1.0
    hot_b: Dict[int, float] = {}
    for r in history_records:
        ctx = r.get("context") or {}
        for key in ("batch", "ed25519_batch", "gg18_ot_mta_batch",
                    "dkg_batch", "reshare_batch"):
            b = ctx.get(key)
            if isinstance(b, int) and b > 0:
                hot_b[b] = hot_b.get(b, 0.0) + 0.5
    for b, v in hot_b.items():
        w[("__B__", str(b))] = v
    return w


def load_traffic(ledger_path: Optional[str] = None,
                 history_path: Optional[str] = None
                 ) -> Dict[Tuple[str, str], float]:
    """Best-effort read of the traffic files (the compile ledger, a JSONL
    bench history). Missing or malformed files contribute no weight."""
    entries: List[dict] = []
    records: List[dict] = []
    if ledger_path:
        try:
            with open(ledger_path) as f:
                doc = json.load(f)
            entries = list(doc.get("entries") or [])
        except (OSError, ValueError):
            pass
    if history_path:
        try:
            with open(history_path) as f:
                lines = f.readlines()
        except OSError:
            lines = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue  # one bad JSONL line must not erase the rest
    return traffic_weights(entries, records)


# -- enumeration -------------------------------------------------------------


@dataclass
class WarmEntry:
    engine: str
    shape: str
    B: int
    scheme: str
    dims: Dict[str, str] = field(default_factory=dict)
    priority: float = 0.0

    def to_json(self) -> dict:
        return {
            "engine": self.engine,
            "shape": self.shape,
            "B": self.B,
            "scheme": self.scheme,
            "dims": dict(self.dims),
            "priority": round(self.priority, 3),
        }


def _dim_axis(engine: str, name: str, knobs: WarmKnobs, buckets: Sequence[int],
              gaps: List[str]) -> List[str]:
    if name == "B":
        # the batch axis: finite because the scheduler pow-2-snaps it
        return [str(b) for b in buckets]
    vals = knobs.values_for(name)
    if not vals:
        gaps.append(
            f"{engine}: knob dim {name!r} has no warm values configured "
            f"(WarmKnobs gap — the pre-warmer would silently never run "
            f"this signature)"
        )
    return list(vals)


def build_manifest(knobs: WarmKnobs,
                   buckets: Sequence[int] = BUCKETS,
                   schemes: Optional[Sequence[str]] = None,
                   max_b: Optional[int] = None,
                   traffic: Optional[Dict[Tuple[str, str], float]] = None,
                   ) -> Dict[str, object]:
    """Instantiate the serving templates into the concrete warm work-list.

    ``schemes`` filters to scheme families (None = all serving);
    ``max_b`` caps the bucket axis (budget control: the cut is recorded
    in counts, never silent); ``traffic`` orders hot shapes first.
    Returns a JSON-able manifest dict with ``entries`` sorted by
    descending priority then ascending B (cheap entries first cover the
    most inside a deadline)."""
    if max_b is not None:
        buckets = [b for b in buckets if b <= max_b]
    traffic = traffic or {}
    gaps: List[str] = []
    entries: List[WarmEntry] = []
    for engine in sorted(SERVING_TEMPLATES):
        scheme = ENGINE_SCHEME.get(engine, engine.split(".", 1)[0])
        if schemes is not None and scheme not in schemes:
            continue
        template = SERVING_TEMPLATES[engine]
        names = _DIM_RE.findall(template)
        axes = [_dim_axis(engine, nm, knobs, buckets, gaps) for nm in names]
        for combo in itertools.product(*axes):
            shape = template
            for nm, val in zip(names, combo):
                shape = shape.replace("{" + nm + "}", val, 1)
            d = dict(zip(names, combo))
            b = int(d.get("B", "1"))
            prio = traffic.get((engine, shape), 0.0)
            prio += traffic.get(("__B__", str(b)), 0.0)
            entries.append(WarmEntry(
                engine=engine, shape=shape, B=b, scheme=scheme,
                dims=d, priority=prio,
            ))
    entries.sort(key=lambda e: (-e.priority, e.B, e.engine, e.shape))
    return {
        "comment": (
            "Warm work-list derived from the serving templates "
            "(mpcium_tpu_torch/warm/manifest.py SERVING_TEMPLATES x "
            "WarmKnobs x engine/buckets.BUCKETS), hot shapes first. Valid "
            "only under the environment key."
        ),
        "key": manifest_key(),
        "knobs": knobs.to_json(),
        "buckets": list(buckets),
        "schemes": list(schemes) if schemes is not None else list(ALL_SCHEMES),
        "gaps": gaps,
        "entries": [e.to_json() for e in entries],
        "counts": {
            "entries": len(entries),
            "serving_templates": len(SERVING_TEMPLATES),
            "buckets": len(buckets),
        },
    }


def manifest_entries(manifest: Dict[str, object]) -> List[WarmEntry]:
    out = []
    for e in manifest.get("entries", []):  # type: ignore[union-attr]
        out.append(WarmEntry(
            engine=str(e["engine"]), shape=str(e["shape"]),
            B=int(e["B"]), scheme=str(e.get("scheme", "")),
            dims=dict(e.get("dims", {})),
            priority=float(e.get("priority", 0.0)),
        ))
    return out
