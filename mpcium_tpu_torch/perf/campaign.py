"""The resumable step runner of a measurement round on the card.

The port of the JAX package's ``perf/campaign.py``: a round is an ordered
list of ``Step``\\ s, each run in a subprocess under its own timeout (one
hung step never kills the round), checkpointed to a JSONL state file
after every step (a round cut between chip calls resumes where it
stopped), streamed as campaign spans plus a ``.prom`` heartbeat, and
assembled into one ``GPU_CAMPAIGN_*.json`` report that the port's perf
ledger ingests into its own history (``perf/ledger.build_gpu_history``).

The state file is append-only JSONL: one header line, then one line per
finished step, each flushed and fsync'd before the next step starts.
A SIGKILL mid-step loses at most the step in flight; a SIGKILL
mid-*write* leaves a torn tail, which ``load_state`` detects (an
unparseable last line), truncates, and re-runs.

For the same steps, the plan fingerprint and the state lines are the
JAX runner's, apart from times and the ``env`` stamp (the port's
``perf/envfp``). Its files are named apart: ``GPU_CAMPAIGN_state.json``
and ``gpu_campaign_heartbeat.prom``. The step drivers live in
``scripts/torch_gpu_round.py``. This module imports no torch (the runner
must never hold the card its step subprocesses measure), and reads the
span sink only where a caller has already imported ``utils/tracing``.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Sequence

from ..utils.metrics import MetricsRegistry
from .envfp import env_fingerprint

STATE_BASENAME = "GPU_CAMPAIGN_state.json"
HEARTBEAT_BASENAME = "gpu_campaign_heartbeat.prom"

# step state gauge values for the heartbeat
_PENDING, _RUNNING, _DONE, _DNF = 0.0, 1.0, 2.0, 3.0


class Step:
    """One subprocess-isolated campaign step.

    ``parse`` maps captured stdout to the step's result dict; the
    default takes the LAST line that parses as a JSON object (every
    bench/driver in this repo prints its record as a single JSON line,
    possibly after warm-up noise). ``needs`` lists step ids that must
    have finished OK first — a failed dependency skips the dependent
    with a structured DNF instead of burning window time on it.
    """

    def __init__(
        self,
        step_id: str,
        argv: Sequence[str],
        *,
        env: Optional[Dict[str, str]] = None,
        timeout_s: float = 600.0,
        needs: Sequence[str] = (),
        parse: Optional[Callable[[str], dict]] = None,
        cwd: Optional[str] = None,
    ):
        self.id = step_id
        self.argv = list(argv)
        self.env = dict(env or {})
        self.timeout_s = float(timeout_s)
        self.needs = list(needs)
        self.parse = parse or last_json_line
        self.cwd = cwd

    def plan_entry(self) -> dict:
        return {"id": self.id, "argv": self.argv, "env": self.env,
                "timeout_s": self.timeout_s, "needs": self.needs}


def last_json_line(stdout: str) -> dict:
    for line in reversed(stdout.splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict):
            return doc
    raise ValueError("no JSON object line in step stdout")


def plan_fingerprint(steps: Sequence[Step]) -> str:
    """Identity of the step DAG: resuming a state file recorded under a
    DIFFERENT plan must be an error, not a silent skip-mismatch."""
    doc = json.dumps([s.plan_entry() for s in steps], sort_keys=True)
    return hashlib.sha256(doc.encode()).hexdigest()[:16]


# -- state file (append-only JSONL, torn-tail tolerant) ----------------------


class StateMismatch(RuntimeError):
    """State file belongs to a different plan/campaign."""


def load_state(path: str) -> dict:
    """Replay the checkpoint file. Returns ``{"header": dict|None,
    "results": {step_id: line}, "torn": bool}``. An unparseable LAST
    line is a torn tail (killed mid-write): it is dropped and the file
    truncated to the surviving prefix. An unparseable line anywhere
    else is corruption and raises — resuming over it would silently
    skip real work."""
    header = None
    results: Dict[str, dict] = {}
    torn = False
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return {"header": None, "results": {}, "torn": False}
    lines = raw.split(b"\n")
    good_bytes = 0
    for i, line in enumerate(lines):
        if not line.strip():
            good_bytes += len(line) + 1
            continue
        try:
            doc = json.loads(line)
            if not isinstance(doc, dict):
                raise ValueError("state line is not an object")
        except ValueError:
            rest = b"".join(lines[i + 1:]).strip()
            if rest:
                raise StateMismatch(
                    f"{path}: corrupt line {i + 1} with data after it — "
                    f"not a torn tail; refusing to resume over it"
                )
            torn = True
            break
        good_bytes += len(line) + 1
        if "campaign" in doc and "step" not in doc:
            header = doc
        elif "step" in doc:
            results[doc["step"]] = doc
    if torn:
        with open(path, "r+b") as f:
            f.truncate(max(good_bytes - 1, 0) if good_bytes else 0)
            f.flush()
            os.fsync(f.fileno())
    return {"header": header, "results": results, "torn": torn}


def _append_state(path: str, doc: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(doc, sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())


# -- the runner --------------------------------------------------------------


class Campaign:
    def __init__(
        self,
        name: str,
        steps: Sequence[Step],
        *,
        state_path: str,
        rehearse: bool = False,
        heartbeat_path: Optional[str] = None,
        log: Callable[[str], None] = print,
    ):
        self.name = name
        self.steps = list(steps)
        self.state_path = state_path
        self.rehearse = rehearse
        self.heartbeat_path = heartbeat_path
        self.log = log
        self.metrics = MetricsRegistry()
        self._t0 = time.monotonic()
        self._fp = plan_fingerprint(self.steps)
        ids = [s.id for s in self.steps]
        if len(ids) != len(set(ids)):
            raise ValueError(f"duplicate step ids in plan: {ids}")

    # -- heartbeat ----------------------------------------------------------

    def _beat(self, current: Optional[str], results: Dict[str, dict],
              last_rc: Optional[int] = None) -> None:
        m = self.metrics
        done = sum(1 for r in results.values()
                   if not (r.get("result") or {}).get("dnf"))
        dnf = len(results) - done
        m.gauge("campaign.steps_total").set(float(len(self.steps)))
        m.gauge("campaign.steps_done").set(float(done))
        m.gauge("campaign.steps_dnf").set(float(dnf))
        m.gauge("campaign.elapsed_s").set(
            round(time.monotonic() - self._t0, 3))
        if last_rc is not None:
            m.gauge("campaign.last_step_rc").set(float(last_rc))
        for s in self.steps:
            if s.id in results:
                state = (_DNF if (results[s.id].get("result") or {}).get("dnf")
                         else _DONE)
            elif s.id == current:
                state = _RUNNING
            else:
                state = _PENDING
            m.gauge(f"campaign.step.{s.id}.state").set(state)
        if self.heartbeat_path:
            tmp = self.heartbeat_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(m.to_prometheus(labels={"campaign": self.name}))
            os.replace(tmp, self.heartbeat_path)

    # -- one step -----------------------------------------------------------

    def _run_step(self, step: Step) -> dict:
        env = dict(os.environ)
        env.update(step.env)
        t0 = time.monotonic()
        t0_ns = time.time_ns()
        try:
            proc = subprocess.run(
                step.argv, env=env, cwd=step.cwd,
                capture_output=True, text=True, timeout=step.timeout_s,
            )
            rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            elapsed = round(time.monotonic() - t0, 3)
            result = {
                "dnf": True,
                "reason": f"watchdog: step exceeded {step.timeout_s:.0f}s",
                "elapsed_s": elapsed,
                "env": env_fingerprint(),
            }
            tail = (e.stdout or b"")
            if isinstance(tail, bytes):
                tail = tail.decode(errors="replace")
            return {"step": step.id, "rc": None, "result": result,
                    "elapsed_s": elapsed, "tail": tail[-500:],
                    "t0_ns": t0_ns, "t1_ns": time.time_ns()}
        elapsed = round(time.monotonic() - t0, 3)
        if rc != 0:
            result = {
                "dnf": True,
                "reason": f"rc={rc}: {stderr.strip()[-300:] or 'no stderr'}",
                "elapsed_s": elapsed,
                "env": env_fingerprint(),
            }
        else:
            try:
                result = step.parse(stdout)
            except Exception as e:  # noqa: BLE001 — unparseable = DNF
                result = {
                    "dnf": True,
                    "reason": f"unparseable step output: {e}",
                    "elapsed_s": elapsed,
                    "env": env_fingerprint(),
                }
        return {"step": step.id, "rc": rc, "result": result,
                "elapsed_s": elapsed, "tail": stdout[-500:],
                "t0_ns": t0_ns, "t1_ns": time.time_ns()}


    def _emit_span(self, line: dict) -> None:
        # utils/tracing imports torch: a runner that never imported it
        # has no sink armed, and must not pay for torch to find that out
        tracing = sys.modules.get(__package__.rsplit(".", 1)[0] + ".utils.tracing")
        if tracing is None:
            return
        try:
            if not tracing.enabled():
                return
            result = line.get("result") or {}
            tracing.emit(
                f"campaign:{line['step']}",
                line.get("t0_ns") or 0,
                line.get("t1_ns") or 0,
                node="campaign", tid=self.name,
                rc=line.get("rc") if line.get("rc") is not None else -1,
                dnf=1 if result.get("dnf") else 0,
            )
        except Exception:  # noqa: BLE001 — spans must never kill a step
            pass

    # -- the loop -----------------------------------------------------------

    def run(self) -> dict:
        """Execute the plan, resuming from the state file. Returns the
        assembled campaign report (also see ``report()``)."""
        state = load_state(self.state_path)
        if state["torn"]:
            self.log(f"campaign: torn tail truncated in {self.state_path}; "
                     f"the interrupted step will re-run")
        header = state["header"]
        if header is not None:
            if header.get("plan_fp") != self._fp:
                raise StateMismatch(
                    f"{self.state_path} was recorded under a different "
                    f"plan (fp {header.get('plan_fp')} != {self._fp}); "
                    f"delete it or pass a fresh --state path"
                )
        else:
            _append_state(self.state_path, {
                "campaign": self.name, "plan_fp": self._fp,
                "rehearse": self.rehearse,
                "steps": [s.id for s in self.steps],
            })
        results = state["results"]
        for step in self.steps:
            if step.id in results:
                self.log(f"campaign: [{step.id}] already finished — "
                         f"skipping (resume)")
                continue
            bad_needs = [
                n for n in step.needs
                if (results.get(n) or {}).get("result", {}).get("dnf")
                or n not in results
            ]
            if bad_needs:
                line = {
                    "step": step.id, "rc": None,
                    "result": {
                        "dnf": True,
                        "reason": f"dependency not satisfied: {bad_needs}",
                        "elapsed_s": 0.0,
                        "env": env_fingerprint(),
                    },
                    "elapsed_s": 0.0, "tail": "",
                }
                results[step.id] = line
                _append_state(self.state_path, line)
                self._beat(None, results)
                self.log(f"campaign: [{step.id}] DNF (deps: {bad_needs})")
                continue
            self._beat(step.id, results)
            self.log(f"campaign: [{step.id}] running "
                     f"(timeout {step.timeout_s:.0f}s): "
                     f"{' '.join(step.argv[:6])}…")
            line = self._run_step(step)
            results[step.id] = line
            _append_state(self.state_path, line)
            self._emit_span(line)
            self._beat(None, results, last_rc=line.get("rc"))
            verdict = ("DNF: " + line["result"].get("reason", "?")
                       if line["result"].get("dnf")
                       else f"ok in {line['elapsed_s']:.1f}s")
            self.log(f"campaign: [{step.id}] {verdict}")
        return self.report(results)

    # -- report assembly ----------------------------------------------------

    def report(self, results: Dict[str, dict]) -> dict:
        steps_doc = {}
        dnf = 0
        for s in self.steps:
            line = results.get(s.id)
            if line is None:
                dnf += 1
                steps_doc[s.id] = {"dnf": True, "reason": "never ran"}
                continue
            res = dict(line.get("result") or {})
            if res.get("dnf"):
                dnf += 1
            res["_elapsed_s"] = line.get("elapsed_s")
            res["_rc"] = line.get("rc")
            steps_doc[s.id] = res
        done = len(self.steps) - dnf
        complete = dnf == 0
        # the runner itself imports no torch, so its own fingerprint
        # says "uninitialized"; the record's platform must be the one
        # the step subprocesses measured on, or a live round on the
        # card would report itself as degraded
        env = env_fingerprint()
        if env.get("platform") in (None, "uninitialized"):
            for res in steps_doc.values():
                senv = res.get("env") if isinstance(res, dict) else None
                if isinstance(senv, dict) and senv.get("platform") not in (
                        None, "uninitialized", "unavailable", "none"):
                    for k in ("platform", "device_kind", "device_count"):
                        if senv.get(k) is not None:
                            env[k] = senv[k]
                    break
        metrics = lift_metrics(steps_doc)
        metrics.update({
            "campaign_complete": 1.0 if complete else 0.0,
            "campaign_steps_total": float(len(self.steps)),
            "campaign_steps_done": float(done),
            "campaign_steps_dnf": float(dnf),
        })
        return {
            "comment": (
                f"Campaign report '{self.name}' — generated by "
                f"scripts/torch_gpu_round.py; one record per step, metrics "
                f"lifted for the port's perf ledger."
            ),
            "campaign": self.name,
            "rehearse": self.rehearse,
            "plan_fp": self._fp,
            "steps_total": len(self.steps),
            "steps_done": done,
            "steps_dnf": dnf,
            "complete": complete,
            "steps": steps_doc,
            "metrics": metrics,
            "context": lift_context(steps_doc),
            "env": env,
            "elapsed_s": round(time.monotonic() - self._t0, 3),
            "measured_at": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime()),
        }


# -- metric lifting ----------------------------------------------------------

# step-result keys hoisted to campaign-level metrics when numeric; the
# ledger reads ONLY these (plus *_per_sec rates) so a step result's
# internal timings can't masquerade as headline numbers
_LIFT_KEYS = (
    "idle_fraction_k1", "idle_fraction_k2", "idle_fraction_k4",
    "warmboot_first_sign_s", "warmboot_cache_misses",
    "warmboot_cache_hits",
)
_LIFT_CONTEXT = (
    "gg18_ot_checks_s", "gg18_ot_checks_on_s", "gg18_ot_checks_off_s",
    "gg18_ot_mta_device_s", "gg18_ot_mta_host_s", "device_idle_fraction",
)


def lift_metrics(steps_doc: Dict[str, dict]) -> Dict[str, float]:
    """Hoist each step's headline numbers into the campaign record so
    the claims engine evaluates ONE artifact per round."""
    out: Dict[str, float] = {}
    for _sid, res in sorted(steps_doc.items()):
        if not isinstance(res, dict) or res.get("dnf"):
            continue
        for k, v in res.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if k.endswith(("_per_sec", "_per_s")) or k in _LIFT_KEYS:
                out[k] = float(v)
        sweep = res.get("b_sweep")
        if isinstance(sweep, dict):
            for bsz, entry in sweep.items():
                if isinstance(entry, (int, float)) \
                        and not isinstance(entry, bool):
                    out[f"b_sweep_{bsz}_sigs_per_sec"] = float(entry)
    return out


def lift_context(steps_doc: Dict[str, dict]) -> Dict[str, object]:
    """Context numbers (timings, phase tables) the claims engine reads
    via ``ctx:``/derived metrics — kept separate from rate metrics."""
    out: Dict[str, object] = {}
    for _sid, res in sorted(steps_doc.items()):
        if not isinstance(res, dict) or res.get("dnf"):
            continue
        for k in _LIFT_CONTEXT:
            v = res.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = float(v)
        for k in ("phase_s", "gg18_ot_mta_phase_s"):
            if isinstance(res.get(k), dict) and res[k] \
                    and "no_spans" not in res[k]:
                out[k] = res[k]
        comp = res.get("compile")
        if isinstance(comp, dict):
            if isinstance(comp.get("unpredicted"), (int, float)):
                out["compile_unpredicted"] = float(comp["unpredicted"])
            if isinstance(comp.get("compiles"), (int, float)):
                out["compile_count"] = float(comp["compiles"])
    return out
