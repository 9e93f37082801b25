"""The pre-warmer: walk the warm manifest before advertising ready.

The port of ``mpcium_tpu/warm/prewarm.py``. Each manifest entry names
one (engine, shape) bucket, and its runner drives the real engine or
party entry point at that exact shape, on an explicit device, with
throwaway dealer wallets (the Paillier ones on the committed 1024-bit
fixture, with the GG18 domains it can carry, and every signature they
make must verify). The JAX package warms to fill XLA's persistent
cache. The port compiles K0's CUDA library (built at its first launch
and cached on disk by source digest, ``ops/mulmod.build``) and, per
shape, the EdDSA and GG18 engines' CUDA graphs (``engine/graphs``), which live in
the process that captured them. So "warm" here means the bucket has run
once in this process on that device, which pays its first-use costs
there: the device context and allocator, the per-modulus Barrett
contexts and comb tables, the lazily built curve tables, K0's build or
load, and the capture of the bucket's EdDSA or GG18 graphs.

The walk is budget-aware and failure-isolated, as in JAX: a deadline
miss marks the remaining entries ``skipped`` (the daemon goes ready
anyway: cold, but alive), a runner exception marks that entry
``failed`` without taking boot down, and an entry this process has
already run on that device is ``already``. The report lands as
``WARM_MANIFEST.json`` with JAX's keys and totals. Where an entry
reached graphed functions (the EdDSA and GG18 engines and parties on
CUDA), its row carries ``graphs`` — ``hits``, the graphs it found
captured and replayed, and ``misses``, the graphs it captured — and
``cache`` is ``miss`` if it captured any, else ``hit``; the totals add
those graph counts, and an entry that also launched K0 carries K0's
build verdict as ``k0``. Otherwise
``cache`` is K0's build verdict (``hit`` / ``miss``, from
``perf/compile_watch``) where the entry launched K0, else ``"none"``, and
the totals count that verdict. ``unpredicted`` stays 0 (the port's
shapes come from its own template table, not a static surface).

No counterpart: ``configure_cache`` (it points XLA's persistent cache at
a directory) and ``warm/aot.py`` (``jax.export`` artifacts): a CUDA graph
cannot be stored across processes, and K0's library is already cached.
"""
from __future__ import annotations

import json
import os
import secrets
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..engine import graphs
from ..perf import compile_watch
from ..utils import log
from . import manifest as wm

_LOCK = threading.Lock()
_RAN: Set[Tuple[str, str, str]] = set()  # (engine, shape, device) run in this process


def _ids(n: int) -> List[str]:
    return [f"warm{i}" for i in range(n)]


def _digests(B: int) -> np.ndarray:
    return np.stack([np.frombuffer(bytes([i % 256]) * 32, dtype=np.uint8) for i in range(B)])


def _messages(B: int) -> List[bytes]:
    return [bytes([i % 256]) * 32 for i in range(B)]


# the GG18 domains the 1024-bit fixture can carry (its N is too short
# for the full ones: β′ < q⁵ alone needs 1272 bits); the tests sign with
# the same fixture and domains
_FIXTURE_DOMAINS = {"alpha": 600, "beta_prime": 320, "gamma_bob": 600}


def _test_preparams(ids: Sequence[str]) -> Dict[str, object]:
    """The committed fixed Paillier fixtures (1024-bit) mapped onto the
    warm party ids: warming never pays a safe-prime search."""
    from ..cluster import load_test_preparams

    tp = load_test_preparams(bits=1024)
    pool = [tp[k] for k in sorted(tp)]
    return {pid: pool[i % len(pool)] for i, pid in enumerate(ids)}


def _all_ok(ok, what: str) -> None:
    if not bool(np.asarray(ok).all()):
        raise RuntimeError(f"warm {what} produced an invalid signature")


# -- per-engine runners ------------------------------------------------------
#
# Each runner runs the bucket of ONE manifest entry on ``dev``. Dims come
# from the entry (strings, straight from the template).


def _run_eddsa_sign(e: wm.WarmEntry, dev: torch.device) -> None:
    from ..engine import eddsa_batch as eb

    q = int(e.dims["q"])
    ids = _ids(q + 1)
    shares = eb.dealer_keygen_batch(e.B, ids, q - 1, rng=secrets)
    _, ok = eb.BatchedCoSigners(ids[:q], shares[:q], rng=secrets, device=dev).sign(
        _messages(e.B))
    _all_ok(ok, "eddsa.sign")


def _run_dkg_run(e: wm.WarmEntry, dev: torch.device) -> None:
    from ..engine import dkg_batch as db

    q = int(e.dims["q"])
    db.BatchedDKG(_ids(q), q - 1, e.dims["key_type"], rng=secrets, device=dev).run(e.B)


def _dealt(key_type: str, B: int, ids: Sequence[str], t: int):
    if key_type == "secp256k1":
        from ..engine import gg18_batch as gb

        return gb.dealer_keygen_secp_batch(B, ids, t, rng=secrets)
    from ..engine import eddsa_batch as eb

    return eb.dealer_keygen_batch(B, ids, t, rng=secrets)


def _run_reshare_run(e: wm.WarmEntry, dev: torch.device) -> None:
    from ..engine import dkg_batch as db

    t_new = int(e.dims["t_new"])
    committee = _ids(max(t_new + 1, 2))
    old = _dealt(e.dims["key_type"], e.B, committee, 1)
    db.BatchedReshare(committee[:2], old[:2], committee, t_new, rng=secrets,
                      device=dev).run()


def _run_gg18_sign(e: wm.WarmEntry, dev: torch.device) -> None:
    from ..engine import gg18_batch as gb

    q = int(e.dims["q"])
    mta = e.dims["mta_impl"]
    ids = _ids(q + 1)
    shares = gb.dealer_keygen_secp_batch(e.B, ids, q - 1, rng=secrets)
    pre = _test_preparams(ids[:q]) if mta == "paillier" else None
    signer = gb.GG18BatchCoSigners(ids[:q], shares[:q], pre, gb.Domains(**_FIXTURE_DOMAINS),
                                   rng=secrets, mta_impl=mta, device=dev)
    _all_ok(signer.sign(_digests(e.B))["ok"], "gg18.sign")


def _run_party_dkg(e: wm.WarmEntry, dev: torch.device) -> None:
    from ..protocol.batch_dkg import BatchedDKGParty
    from ..protocol.runner import run_protocol

    q = int(e.dims["q"])
    key_type = e.dims["key_type"]
    ids = _ids(q)
    pre = _test_preparams(ids) if key_type == "secp256k1" else {}
    run_protocol({
        pid: BatchedDKGParty("warm-dkg", pid, ids, q - 1, key_type, e.B,
                             preparams=pre.get(pid), min_paillier_bits=512, rng=secrets,
                             device=dev)
        for pid in ids
    })


def _run_party_ecdsa(e: wm.WarmEntry, dev: torch.device) -> None:
    from ..engine import gg18_batch as gb
    from ..protocol.ecdsa.batch_signing import BatchedECDSASigningParty
    from ..protocol.runner import run_protocol

    q = int(e.dims["q"])
    ids = _ids(q)
    shares = gb.dealer_keygen_secp_batch(e.B, ids, q - 1, rng=secrets,
                                         preparams=_test_preparams(ids))
    parties = {
        pid: BatchedECDSASigningParty("warm-ecdsa", pid, ids, shares[i], _messages(e.B),
                                      gb.Domains(**_FIXTURE_DOMAINS), rng=secrets, device=dev)
        for i, pid in enumerate(ids)
    }
    run_protocol(parties)
    for p in parties.values():
        _all_ok(p.result["ok"], "party.ecdsa")


def _run_party_reshare(e: wm.WarmEntry, dev: torch.device) -> None:
    from ..protocol.batch_dkg import BatchedReshareParty
    from ..protocol.runner import run_protocol

    # q in the shape is |old ∪ new|: the same committee re-deals to itself
    q = int(e.dims["q"])
    t_new = int(e.dims["t_new"])
    key_type = e.dims["key_type"]
    ids = _ids(q)
    old = _dealt(key_type, e.B, ids, t_new)
    pre = _test_preparams(ids) if key_type == "secp256k1" else {}
    run_protocol({
        pid: BatchedReshareParty("warm-reshare", pid, key_type, ids, ids, t_new, e.B,
                                 old_shares=old[i], preparams=pre.get(pid),
                                 min_paillier_bits=512, rng=secrets, device=dev)
        for i, pid in enumerate(ids)
    })


RUNNERS: Dict[str, Callable[[wm.WarmEntry, torch.device], None]] = {
    "eddsa.sign": _run_eddsa_sign,
    "dkg.run": _run_dkg_run,
    "reshare.run": _run_reshare_run,
    "gg18.sign": _run_gg18_sign,
    "party.dkg": _run_party_dkg,
    "party.ecdsa": _run_party_ecdsa,
    "party.reshare": _run_party_reshare,
}


def _k0_launches() -> int:
    from ..ops import mulmod as K

    with K._count_lock:
        return K.launches + sum(K.powmod_launches_by_mode_width.values())


def _k0_builds() -> int:
    """K0 builds (or loads) in the compile ledger; graph captures are
    ledgered there too."""
    return sum(1 for le in compile_watch.entries() if le["engine"] == "mulmod")


def _graph_verdicts(before: Dict[tuple, int], after: Dict[tuple, int]) -> Tuple[int, int]:
    """(hits, misses) between two ``graphs.snapshot()``: graphs that
    were captured before and replayed since, graphs captured since."""
    misses = sum(1 for k in after if k not in before)
    hits = sum(1 for k, n in after.items() if k in before and n > before[k])
    return hits, misses


# -- the walk ----------------------------------------------------------------


def prewarm(
    manifest: dict,
    budget_s: float = 300.0,
    *,
    report_dir: Optional[str] = None,
    device: DeviceLike = None,
    now: Callable[[], float] = time.monotonic,
) -> dict:
    """Walk the manifest (hot shapes first) on ``device`` (None: the GPU)
    until covered or out of budget. Returns — and writes, when
    ``report_dir`` is given — the ``WARM_MANIFEST.json`` report: one
    verdict per signature plus totals. Only resolving the device raises:
    a failed entry is a report line, not a boot failure."""
    dev = resolve(device)
    deadline = now() + budget_s
    results: List[dict] = []
    totals = {
        "entries": 0, "warmed": 0, "already": 0, "skipped": 0,
        "failed": 0, "hits": 0, "misses": 0, "unpredicted": 0,
    }
    for e in wm.manifest_entries(manifest):
        totals["entries"] += 1
        row = {"engine": e.engine, "shape": e.shape, "B": e.B,
               "scheme": e.scheme, "priority": e.priority, "device": str(dev)}
        results.append(row)
        key = (e.engine, e.shape, str(dev))
        if now() >= deadline:
            row["status"] = "skipped"
            row["reason"] = "budget exhausted"
            totals["skipped"] += 1
            continue
        with _LOCK:
            ran = key in _RAN
        if ran:
            row["status"] = "already"
            totals["already"] += 1
            continue
        runner = RUNNERS.get(e.engine)
        if runner is None:
            row["status"] = "failed"
            row["reason"] = f"no warm runner for engine {e.engine!r}"
            totals["failed"] += 1
            continue
        k0_before, builds_before = _k0_launches(), _k0_builds()
        graphs_before = graphs.snapshot()
        t0 = now()
        try:
            runner(e, dev)
        except Exception as exc:  # noqa: BLE001 — warming must not kill boot
            row["status"] = "failed"
            row["reason"] = repr(exc)
            totals["failed"] += 1
            log.warn("warm: entry failed", engine=e.engine, shape=e.shape,
                     error=repr(exc))
            continue
        row["status"] = "warmed"
        row["warm_s"] = round(now() - t0, 3)
        totals["warmed"] += 1
        with _LOCK:
            _RAN.add(key)
        k0 = next((le for le in reversed(compile_watch.entries()) if le["engine"] == "mulmod"),
                  None)
        k0_cache = k0["cache"] if k0 is not None and _k0_launches() > k0_before else "none"
        g_hits, g_misses = _graph_verdicts(graphs_before, graphs.snapshot())
        if g_hits or g_misses:
            row["graphs"] = {"hits": g_hits, "misses": g_misses}
            row["cache"] = "miss" if g_misses else "hit"
            if k0_cache != "none":
                row["k0"] = k0_cache
            totals["hits"] += g_hits
            totals["misses"] += g_misses
        else:
            row["cache"] = k0_cache
            if row["cache"] == "hit":
                totals["hits"] += 1
            elif row["cache"] == "miss":
                totals["misses"] += 1
        if _k0_builds() > builds_before:
            row["compile_s"] = k0["compile_s"]  # K0 was built (or loaded) by this entry
    report = {
        "comment": "pre-warm report: one verdict per warm-manifest "
                   "signature (mpcium_tpu_torch.warm.prewarm)",
        "key": manifest.get("key", wm.manifest_key()),
        "budget_s": budget_s,
        "totals": totals,
        "results": results,
    }
    if report_dir:
        try:
            os.makedirs(report_dir, exist_ok=True)
            path = os.path.join(report_dir, wm.REPORT_BASENAME)
            with open(path, "w") as f:
                json.dump(report, f, indent=1, sort_keys=True)
                f.write("\n")
            report["path"] = path
        except OSError as exc:
            log.warn("warm: could not write report", error=repr(exc))
    return report


# -- daemon / drill entry points ---------------------------------------------


def default_cache_dir(base_dir: str) -> str:
    """Per-host warm directory (the report's home), as in JAX: the host
    fingerprint is in the path."""
    return os.path.join(base_dir, f"warm_cache_{wm.envfp.host_fingerprint()}")


def prewarm_for_daemon(cfg, node_name: str, device: DeviceLike = None) -> Optional[dict]:
    """The boot-time warm pass (node/daemon.py, between ``mark_warming``
    and ``mark_ready``) on the node's device; the report goes to
    ``warm_cache_dir`` or :func:`default_cache_dir` of the node's db dir.
    Never raises: a broken warm config degrades to a cold-but-serving
    node, loudly."""
    try:
        db_dir = os.path.join(cfg.db_dir, node_name)
        cache_dir = cfg.warm_cache_dir or default_cache_dir(db_dir)
        knobs = wm.knobs_from_config(cfg)
        schemes = tuple(
            s.strip() for s in cfg.warm_schemes.split(",") if s.strip()
        ) or None
        traffic = wm.load_traffic(
            os.path.join(db_dir, compile_watch.LEDGER_BASENAME), None
        )
        manifest = wm.build_manifest(
            knobs, schemes=schemes, max_b=cfg.warm_max_b, traffic=traffic,
        )
        log.info(
            "warm: pre-warming serving set", node=node_name,
            entries=len(manifest["entries"]), budget_s=cfg.warm_budget_s,
            dir=cache_dir, device=str(device),
        )
        report = prewarm(manifest, cfg.warm_budget_s, report_dir=cache_dir, device=device)
        t = report["totals"]
        log.info(
            "warm: pre-warm complete", node=node_name, warmed=t["warmed"],
            already=t["already"], skipped=t["skipped"], failed=t["failed"],
            cache_hits=t["hits"], cache_misses=t["misses"],
        )
        return report
    except Exception as exc:  # noqa: BLE001 — boot must survive a bad warm pass
        log.warn("warm: pre-warm pass failed — serving cold",
                 node=node_name, error=repr(exc))
        return None


def warm_for_drill(budget_s: float = 60.0,
                   device: DeviceLike = None) -> Dict[str, object]:
    """A tiny EdDSA-only warm pass for the kill-resume chaos drill: the
    drill's own signing bucket (q=2, B=2) on ``device`` (None: the GPU),
    reported as ``{warmed, hits, budget_s}``: ``warmed`` the buckets ready
    afterwards, ``hits`` those this process had already run. Never
    raises."""
    try:
        knobs = wm.WarmKnobs(q=(2,), key_type=("ed25519",),
                             mta_impl=("paillier",), t_new=(1,))
        manifest = wm.build_manifest(knobs, buckets=(2,), schemes=("eddsa",))
        t = prewarm(manifest, budget_s, device=device)["totals"]
        return {"warmed": t["warmed"] + t["already"], "hits": t["already"],
                "budget_s": budget_s}
    except Exception as exc:  # noqa: BLE001 — a drill must not die warming
        log.warn("warm: drill warm pass failed", error=repr(exc))
        return {"warmed": 0, "hits": 0, "budget_s": budget_s}
