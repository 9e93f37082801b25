"""SLO load soak: bursty mixed traffic against a LocalCluster under chaos.

The port's copy of the JAX package's ``soak.py``: the same
:class:`SoakConfig` defaults, the same traffic schedule for the same
``seed`` (draw for draw) and the same report keys, with an explicit
``device`` for the cluster (None: the GPU, which raises when there is
none; tests pass ``"cpu"``). The batched EdDSA signs of every burst run
on that device through the batch scheduler.

The serving claim of the batching work is not "a batch completed once"
but "the cluster holds its latency SLO under sustained bursty load while
the network misbehaves, and every request it cannot serve is refused
LOUDLY". This module is that claim's harness:

- a seeded traffic generator drives sign-dominant bursts (plus optional
  keygen/resharing rotations) at a :class:`~mpcium_tpu.cluster.LocalCluster`
  running the SLO scheduler, with a fault plan (default: the
  ``batch-chaos`` catalog entry — delay jitter on every batched-session
  round + drops on the acked unicast channel) active on every node;
- each request carries a lane (interactive/bulk) and a deadline; shed
  requests (backpressure or deadline expiry — always ``retryable`` error
  events, never silence) are retried with fresh tx ids up to a budget,
  and latency is measured from the ORIGINAL submission;
- the report closes the books: ``submitted == succeeded + shed + failed``
  with ``pending == 0`` is the no-silent-drops invariant the smoke test
  and every soak run assert.

Run via ``scripts/torch_load_soak.py``.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from . import wire
from .cluster import LocalCluster, load_test_preparams
from .device import DeviceLike, resolve
from .perf.envfp import env_fingerprint
from .utils import log


@dataclass
class SoakConfig:
    # cluster shape
    n_nodes: int = 3
    threshold: int = 1
    n_wallets: int = 8
    root_dir: Optional[str] = None
    # traffic mix (sign-dominant, like the production workload)
    n_sign: int = 96
    n_keygen: int = 0
    n_reshare: int = 0
    burst_size: int = 16
    burst_gap_s: float = 0.3
    seed: int = 1337
    # SLO shape
    interactive_fraction: float = 0.25
    interactive_deadline_ms: int = 120_000
    bulk_deadline_ms: int = 600_000
    max_retries: int = 2
    retry_backoff_s: float = 0.5
    # chaos (named_plan entry; "" disables fault injection)
    chaos: str = "batch-chaos"
    chaos_seed: int = 7
    chaos_scale: float = 1.0
    # scheduler knobs under test
    batch_window_s: float = 0.25
    batch_max_batch: int = 1024
    batch_max_queue_depth: int = 100_000
    manifest_timeout_s: float = 120.0
    # harness limits
    warmup_signs: int = 0  # pre-clock requests to absorb first-use costs
    wait_timeout_s: float = 900.0


@dataclass
class _Req:
    kind: str  # "sign" | "keygen" | "reshare"
    base_id: str
    wallet_id: str
    lane: str
    deadline_ms: int
    tx: bytes = b""
    submitted_at: float = 0.0
    attempts: int = 0
    status: str = "pending"  # pending|succeeded|shed|failed
    done_at: float = 0.0
    warmup: bool = False


def _pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    i = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * len(sorted_vals) + 0.5)) - 1))
    return sorted_vals[i]


def _latency_summary(vals_ms: List[float]) -> dict:
    s = sorted(vals_ms)
    return {
        "count": len(s),
        "p50": round(_pct(s, 50), 1),
        "p90": round(_pct(s, 90), 1),
        "p99": round(_pct(s, 99), 1),
        "max": round(s[-1], 1) if s else 0.0,
        "mean": round(sum(s) / len(s), 1) if s else 0.0,
    }


class SoakRun:
    """One soak execution: owns the cluster, the result subscriptions,
    the retry worker, and the request ledger keyed by base id."""

    def __init__(self, cfg: SoakConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve(device)
        # deterministic traffic: the schedule (wallet choice, lanes, tx
        # bytes) derives entirely from cfg.seed
        import random

        self._rng = random.Random(cfg.seed)
        self._lock = threading.Lock()
        self._reqs: Dict[str, _Req] = {}
        self._all_done = threading.Event()
        self._retry_q: "queue.Queue[str]" = queue.Queue()
        self._stop = threading.Event()
        self._retries = 0
        self._late_events = 0

        fault_plans = None
        self._plan = None
        if cfg.chaos:
            from .faults.plan import named_plan

            self._plan = named_plan(
                cfg.chaos, seed=cfg.chaos_seed, scale=cfg.chaos_scale
            )
            fault_plans = {"*": self._plan}

        self.cluster = LocalCluster(
            n_nodes=cfg.n_nodes,
            threshold=cfg.threshold,
            root_dir=cfg.root_dir,
            preparams=load_test_preparams(),
            batch_signing=True,
            batch_window_s=cfg.batch_window_s,
            reply_timeout_s=60.0,
            fault_plans=fault_plans,
            batch_max_batch=cfg.batch_max_batch,
            batch_max_queue_depth=cfg.batch_max_queue_depth,
            device=self.device,
        )
        for ec in self.cluster.consumers:
            ec.scheduler.manifest_timeout_s = cfg.manifest_timeout_s

        # dealer-dealt ed25519 wallets: the soak measures SERVING, not DKG
        # (DKG has its own batched path, exercised by n_keygen > 0)
        from .engine import eddsa_batch as eb

        ids = self.cluster.node_ids
        shares = eb.dealer_keygen_batch(
            cfg.n_wallets, ids, threshold=cfg.threshold
        )
        self.wallets = [f"soakw{w}" for w in range(cfg.n_wallets)]
        for w, wid in enumerate(self.wallets):
            for i, nid in enumerate(ids):
                self.cluster.nodes[nid].save_share(shares[i][w], wid)

        self._subs = [
            self.cluster.client.on_sign_result(self._on_sign),
            self.cluster.client.on_wallet_creation_result(self._on_keygen),
            self.cluster.client.on_resharing_result(self._on_reshare),
        ]
        self._retrier = threading.Thread(
            target=self._retry_loop, name="soak-retrier", daemon=True
        )
        self._retrier.start()

    # -- result classification ---------------------------------------------

    def _terminal(self, base_id: str, ev_kind: str, ok: bool,
                  retryable: bool) -> None:
        """Apply one result event to the ledger. First terminal outcome
        wins; duplicates (chaos) and post-terminal stragglers are counted
        but ignored. A retryable failure consumes an attempt and either
        requeues or goes terminal-shed."""
        retry = False
        with self._lock:
            r = self._reqs.get(base_id)
            if r is None or r.kind != ev_kind or r.status != "pending":
                self._late_events += 1
                return
            if ok:
                r.status = "succeeded"
                r.done_at = time.monotonic()
            elif retryable and r.attempts <= self.cfg.max_retries:
                retry = True  # requeue outside the lock
            else:
                r.status = "shed" if retryable else "failed"
                r.done_at = time.monotonic()
            self._check_done_locked()
        if retry:
            self._retry_q.put(base_id)

    def _on_sign(self, ev: wire.SigningResultEvent) -> None:
        base = ev.tx_id.split("~r")[0]
        self._terminal(base, "sign",
                       ev.result_type == wire.RESULT_SUCCESS,
                       bool(getattr(ev, "retryable", False)))

    def _on_keygen(self, ev: wire.KeygenSuccessEvent) -> None:
        self._terminal(ev.wallet_id, "keygen",
                       ev.result_type == wire.RESULT_SUCCESS,
                       bool(getattr(ev, "retryable", False)))

    def _on_reshare(self, ev: wire.ResharingSuccessEvent) -> None:
        self._terminal(ev.wallet_id, "reshare",
                       ev.result_type == wire.RESULT_SUCCESS,
                       bool(getattr(ev, "retryable", False)))

    def _check_done_locked(self) -> None:
        if all(r.status != "pending" for r in self._reqs.values()):
            self._all_done.set()

    # -- submission ---------------------------------------------------------

    def _submit(self, r: _Req) -> None:
        """(Re)issue a request. Sign retries use a fresh tx id — the
        durable queue dedups on tx id for its window, and the scheduler's
        claim for the shed attempt was released, so a fresh id is both
        necessary and sufficient."""
        r.attempts += 1
        if r.submitted_at == 0.0:
            r.submitted_at = time.monotonic()
        if r.kind == "sign":
            tx_id = (r.base_id if r.attempts == 1
                     else f"{r.base_id}~r{r.attempts - 1}")
            self.cluster.client.sign_transaction(wire.SignTxMessage(
                key_type="ed25519",
                wallet_id=r.wallet_id,
                network_internal_code="sol",
                tx_id=tx_id,
                tx=r.tx,
                deadline_ms=r.deadline_ms,
                priority=r.lane,
            ))
        elif r.kind == "keygen":
            # GenerateKeyMessage carries no SLO fields (frozen wire
            # format) — keygen rides the config-default deadline
            self.cluster.client.create_wallet(r.wallet_id)
        else:
            self.cluster.client.resharing(
                r.wallet_id, self.cfg.threshold, "ed25519",
                deadline_ms=r.deadline_ms, priority=r.lane,
            )

    def _retry_loop(self) -> None:
        while not self._stop.is_set():
            try:
                base_id = self._retry_q.get(timeout=0.2)
            except queue.Empty:
                continue
            self._stop.wait(self.cfg.retry_backoff_s)
            with self._lock:
                r = self._reqs.get(base_id)
                if r is None or r.status != "pending":
                    continue
                self._retries += 1
            try:
                self._submit(r)
            except Exception as e:  # noqa: BLE001 — soak must keep counting
                with self._lock:
                    r.status = "failed"
                    r.done_at = time.monotonic()
                    self._check_done_locked()
                log.warn("soak retry submit failed",
                         req=base_id, error=repr(e))

    def _mk_sign(self, i: int, warmup: bool = False) -> _Req:
        rng = self._rng
        lane = (wire.PRIORITY_INTERACTIVE
                if rng.random() < self.cfg.interactive_fraction
                else wire.PRIORITY_BULK)
        return _Req(
            kind="sign",
            base_id=f"{'warm' if warmup else 'soak'}-s{i}",
            wallet_id=self.wallets[rng.randrange(len(self.wallets))],
            lane=lane,
            deadline_ms=(self.cfg.interactive_deadline_ms
                         if lane == wire.PRIORITY_INTERACTIVE
                         else self.cfg.bulk_deadline_ms),
            tx=bytes(rng.getrandbits(8) for _ in range(32)),
            warmup=warmup,
        )

    # -- the run ------------------------------------------------------------

    def run(self) -> dict:
        try:
            return self._run_inner()
        finally:
            self._stop.set()
            self._retrier.join(5.0)
            for sub in self._subs:
                try:
                    sub.unsubscribe()
                except Exception:  # noqa: BLE001
                    pass
            self.cluster.close()

    def _run_inner(self) -> dict:
        cfg = self.cfg
        # warmup: absorb first-use costs before the measured clock
        # starts; warmup requests are ledgered (accounting stays closed)
        # but excluded from the report totals
        if cfg.warmup_signs > 0:
            warm = [self._mk_sign(i, warmup=True)
                    for i in range(cfg.warmup_signs)]
            with self._lock:
                for r in warm:
                    self._reqs[r.base_id] = r
            for r in warm:
                self._submit(r)
            self._wait_all(cfg.wait_timeout_s, what="warmup")
            with self._lock:
                self._all_done.clear()
            log.info("soak warmup complete", signs=cfg.warmup_signs)

        # the measured schedule: interleave keygen/reshare requests into
        # the sign burst sequence deterministically
        reqs: List[_Req] = [self._mk_sign(i) for i in range(cfg.n_sign)]
        for k in range(cfg.n_keygen):
            reqs.append(_Req(kind="keygen", base_id=f"soak-kg{k}",
                             wallet_id=f"soak-kg{k}",
                             lane=wire.PRIORITY_BULK,
                             deadline_ms=cfg.bulk_deadline_ms))
        for k in range(cfg.n_reshare):
            wid = self.wallets[self._rng.randrange(len(self.wallets))]
            reqs.append(_Req(kind="reshare", base_id=wid, wallet_id=wid,
                             lane=wire.PRIORITY_BULK,
                             deadline_ms=cfg.bulk_deadline_ms))
        # dedupe reshare targets (one rotation per wallet per soak) and
        # spread the non-sign requests through the burst train
        seen, uniq = set(), []
        for r in reqs:
            if r.base_id in seen:
                continue
            seen.add(r.base_id)
            uniq.append(r)
        reqs = uniq
        self._rng.shuffle(reqs)
        with self._lock:
            for r in reqs:
                self._reqs[r.base_id] = r

        t0 = time.monotonic()
        for i in range(0, len(reqs), cfg.burst_size):
            for r in reqs[i:i + cfg.burst_size]:
                self._submit(r)
            if i + cfg.burst_size < len(reqs):
                time.sleep(cfg.burst_gap_s)
        self._wait_all(cfg.wait_timeout_s, what="soak traffic")
        t1 = time.monotonic()
        return self._report(reqs, t0, t1)

    def _wait_all(self, timeout_s: float, what: str) -> None:
        with self._lock:
            self._check_done_locked()
        if not self._all_done.wait(timeout_s):
            with self._lock:
                pending = [b for b, r in self._reqs.items()
                           if r.status == "pending"]
            log.warn(f"{what}: requests still pending at timeout",
                     pending=len(pending), sample=pending[:8])

    # -- reporting ----------------------------------------------------------

    def _report(self, reqs: List[_Req], t0: float, t1: float) -> dict:
        cfg = self.cfg
        with self._lock:
            measured = [r for r in self._reqs.values() if not r.warmup]
            by_status: Dict[str, int] = {}
            for r in measured:
                by_status[r.status] = by_status.get(r.status, 0) + 1
            lat_ms = {
                "overall": [], wire.PRIORITY_INTERACTIVE: [],
                wire.PRIORITY_BULK: [],
            }
            under_slo = 0
            signed = 0
            for r in measured:
                if r.status != "succeeded":
                    continue
                ms = (r.done_at - r.submitted_at) * 1000.0
                lat_ms["overall"].append(ms)
                lat_ms[r.lane].append(ms)
                if r.kind == "sign":
                    signed += 1
                    if ms <= r.deadline_ms:
                        under_slo += 1
            retries = self._retries
            late = self._late_events

        duration_s = max(t1 - t0, 1e-9)
        snap = self.cluster.metrics_snapshot()

        def _ctr(name: str) -> float:
            return sum(s["counters"].get(name, 0.0) for s in snap.values())

        submitted = len(measured)
        succeeded = by_status.get("succeeded", 0)
        shed = by_status.get("shed", 0)
        failed = by_status.get("failed", 0)
        pending = by_status.get("pending", 0)
        report = {
            "config": asdict(cfg),
            "chaos": {
                "plan": cfg.chaos or None,
                "seed": cfg.chaos_seed,
                "scale": cfg.chaos_scale,
                "rules": self._plan.describe() if self._plan else [],
            },
            "outcomes": {
                "submitted": submitted,
                "succeeded": succeeded,
                "shed": shed,
                "failed": failed,
                "pending": pending,
                "retries": retries,
                "late_or_duplicate_events": late,
            },
            "by_kind": {
                k: {
                    "submitted": sum(1 for r in measured if r.kind == k),
                    "succeeded": sum(1 for r in measured
                                     if r.kind == k
                                     and r.status == "succeeded"),
                }
                for k in ("sign", "keygen", "reshare")
            },
            "latency_ms": {k: _latency_summary(v)
                           for k, v in lat_ms.items()},
            "throughput": {
                "duration_s": round(duration_s, 2),
                "sigs_per_s": round(signed / duration_s, 3),
                "sigs_per_s_under_slo": round(under_slo / duration_s, 3),
                "slo_hit_rate": round(under_slo / signed, 4) if signed else 0.0,
            },
            "scheduler": {
                "batches_fired": _ctr("scheduler.batches_fired_total"),
                "shed_total": _ctr("scheduler.shed_total"),
                "shed_backpressure": _ctr(
                    "scheduler.shed_backpressure_total"),
                "shed_deadline": _ctr("scheduler.shed_deadline_total"),
                "deputy_takeovers": _ctr("scheduler.deputy_takeover_total"),
                "fallbacks": _ctr("scheduler.fallback_total"),
                "per_node": snap,
            },
            # the no-silent-drops invariant: every submitted request
            # reached EXACTLY ONE terminal outcome
            "accounting_ok": (pending == 0
                              and submitted == succeeded + shed + failed),
            # env fingerprint (perf/envfp): which git sha / torch / device /
            # host / knob set produced this number
            "env": env_fingerprint(),
            # cluster-wide Prometheus text exposition (also written as a
            # .prom sidecar by scripts/torch_load_soak.py) and the merged
            # cross-node flight-recorder trace (Perfetto-loadable)
            "prometheus": self.cluster.prometheus_text(),
            "trace": self.cluster.trace_snapshot(
                clear=True,
                meta={"soak_seed": cfg.seed, "chaos": cfg.chaos or None},
            ),
        }
        return report


def run_soak(cfg: Optional[SoakConfig] = None,
             device: DeviceLike = None) -> dict:
    """Run one soak on ``device`` (None: the GPU) and return its
    JSON-serializable report."""
    return SoakRun(cfg or SoakConfig(), device=device).run()


def write_report(report: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=False)
        f.write("\n")
