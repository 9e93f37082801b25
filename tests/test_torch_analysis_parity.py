"""The port's analyzers against the JAX package's, snippet by snippet.

Each snippet goes through JAX's mpclint + mpcflow at ``mpcium_tpu/<rel>``
and through the port's at ``mpcium_tpu_torch/<rel>``; both must report
the same ``(rule, line, symbol)`` set, and the same messages and
fingerprints once the package prefix is swapped. The residency pairs
hold a JAX snippet against its torch translation (the table in
``mpcium_tpu_torch/analysis/flow/residency.py``): the same number of
sites, the same kinds under the mapping below, the same ``intentional``
flags. Then the baseline split and the CLI's exit codes, and the port's
own residency rules (host helpers, cohort closures, tensor metadata),
which JAX's analyzer has no counterpart for.
"""
from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest

from mpcium_tpu.analysis import baseline as jax_baseline
from mpcium_tpu.analysis import cli as jax_cli
from mpcium_tpu.analysis import core as jax_core
from mpcium_tpu.analysis import flow as jax_flow
from mpcium_tpu.analysis import rules as jax_rules
from mpcium_tpu.analysis.flow import residency as jax_res
from mpcium_tpu_torch.analysis import baseline as pt_baseline
from mpcium_tpu_torch.analysis import cli as pt_cli
from mpcium_tpu_torch.analysis import core as pt_core
from mpcium_tpu_torch.analysis import flow as pt_flow
from mpcium_tpu_torch.analysis import rules as pt_rules
from mpcium_tpu_torch.analysis.flow import residency as pt_res

pytestmark = pytest.mark.lint

JAX, PORT = "mpcium_tpu", "mpcium_tpu_torch"
JAX_SIDE = (JAX, jax_core, jax_rules, jax_flow)
PORT_SIDE = (PORT, pt_core, pt_rules, pt_flow)


def _analyze(side, rel: str, src: str):
    pkg, core, rules, flow = side
    path = f"{pkg}/{rel}"
    pf = core.ParsedFile(Path(path), path, textwrap.dedent(src).replace(JAX, pkg))
    lint = core.lint_parsed([pf], rules.all_rules())
    taint, _sites = flow.run_flow_parsed([pf])
    # MPL4xx (jax.jit hazards) has no counterpart in the port
    return [f for f in lint.findings + taint.findings if not f.rule.startswith("MPL4")]


def _unprefixed(findings, pkg):
    swap = lambda s: s.replace(pkg + "/", "<pkg>/")  # noqa: E731
    return sorted(
        (f.rule, f.line, f.symbol, swap(f.message), swap(f.fingerprint))
        for f in findings
    )


PROTO, UTILS = "protocol/snippet.py", "utils/snippet.py"

# (id, rel, source, the rules JAX's analyzer reports on it)
CASES = [
    # -- MPL1xx secret hygiene
    ("secret_to_log", PROTO, """
     def f(share):
         log.info("round done", share=share.hex())
     """, {"MPL101", "MPF701"}),
    ("public_names_to_log", PROTO, """
     def f(share, wallet_id):
         log.info("round done", wallet=wallet_id, n=1)
     """, set()),
    ("secret_annotation", PROTO, """
     def f():
         blob = derive()  # mpclint: secret
         log.info("derived", blob=blob)
     """, {"MPL101"}),
    ("secret_in_exception", PROTO, """
     def f(seed):
         raise ValueError(f"bad seed {seed!r}")
     """, {"MPL102", "MPF702"}),
    ("redacted_exception", PROTO, """
     def f(seed):
         raise ValueError("bad seed (redacted)")
     """, set()),
    ("secret_compare", PROTO, """
     def f(tag, expect):
         if tag != expect:
             raise ValueError("bad mac")
     """, {"MPL103"}),
    ("compare_digest", PROTO, """
     import hmac
     def f(tag, expect):
         if not hmac.compare_digest(tag, expect):
             raise ValueError("bad mac")
     """, set()),
    # -- MPL2xx determinism: in scope in protocol/, out of it elsewhere
    ("entropy_in_protocol", PROTO, """
     import os
     import time
     def decide():
         return time.time(), os.urandom(8), random.random()
     """, {"MPL201"}),
    ("entropy_in_faults_plan", "faults/plan.py", """
     import time
     def decide():
         return time.time()
     """, {"MPL201"}),
    ("entropy_out_of_scope", UTILS, """
     import time
     def decide():
         return time.time()
     """, set()),
    ("monotonic_is_allowed", PROTO, """
     import time
     def decide():
         return time.monotonic()
     """, set()),
    ("dict_order_peers", PROTO, """
     def route(peers):
         for p in peers:
             send(p)
         return [p for p, v in peers.items()]
     """, {"MPL202"}),
    ("sorted_peers", PROTO, """
     def route(peers):
         for p in sorted(peers):
             send(p)
     """, set()),
    # -- MPL3xx lock discipline
    ("locked_field_race", PROTO, """
     from mpcium_tpu.utils.annotations import locked_by

     @locked_by("_lock", "_started", "_buffer")
     class Session:
         def __init__(self):
             self._started = False
         def start(self):
             self._started = True
         def push(self, m):
             self._buffer.append(m)
         def _flip(self):  # mpclint: holds=_lock
             self._started = True
     """, {"MPL301"}),
    ("locked_field_delegation", PROTO, """
     from mpcium_tpu.utils.annotations import locked_by

     @locked_by("_lock", "_started")
     class Session:
         def start(self):
             with self._lock:
                 self._mid()
         def restart(self):
             with self._lock:
                 self._flip()
         def _mid(self):
             self._flip()
         def _flip(self):
             self._started = True
     """, {"MPL301"}),
    ("lock_order_cycle", PROTO, """
     class S:
         def a(self):
             with self._lock:
                 with self._cond:
                     pass
         def b(self):
             with self._cond:
                 with self._lock:
                     pass
     """, {"MPL302"}),
    ("lock_order_consistent", PROTO, """
     class Wheel:
         def run(self):
             while True:
                 with self._cond:
                     fn = self._pop()
                 fn()
         def schedule(self):
             with self._lock:
                 with self._cond:
                     pass
     """, set()),
    # -- MPL5xx wire versions and threads
    ("wire_without_version", "wire.py", """
     from dataclasses import dataclass
     @dataclass
     class PingMessage:
         wallet_id: str
     @dataclass
     class PongMessage:
         wallet_id: str
         v: int = 0
         @classmethod
         def from_json(cls, d):
             return cls(d["wallet_id"])
     """, {"MPL501"}),
    ("wire_rule_out_of_scope", "soak.py", """
     from dataclasses import dataclass
     @dataclass
     class PingMessage:
         wallet_id: str
     """, set()),
    ("threads", UTILS, """
     import threading
     def go(fn):
         t = threading.Thread(target=fn)
         t.start()
         threading.Thread(target=fn, daemon=True).start()
         u = threading.Timer(1.0, fn)
         u.daemon = True
         threading.Thread(target=fn, name="ot-host-0").start()
     """, {"MPL502"}),
    # -- MPL6xx hygiene
    ("hygiene", UTILS, """
     import json
     import os

     def f(xs=[], m={}):
         try:
             return os.getpid()
         except:
             return None
     """, {"MPL601", "MPL602", "MPL603"}),
    # -- the suppression syntax
    ("inline_disable", UTILS, """
     def f():
         try:
             pass
         except:  # mpclint: disable=MPL601 — probing optional backends
             pass
     """, set()),
    ("disable_on_the_line_above", PROTO, """
     def f(fault_plan):
         # mpclint: disable=MPL101,MPF701 — the replay handle, not key material
         log.warn("CHAOS", seed=fault_plan.seed)
     """, set()),
    ("file_disable", UTILS, """
     # mpclint: disable-file=MPL601
     def f():
         try:
             pass
         except:
             pass
     """, set()),
    # -- MPF7xx propagation shapes
    ("taint_through_method", PROTO, """
     class Party:
         def _load(self):
             return self.share

         def run(self):
             v = self._load()
             log.info("loaded", v=v)
     """, {"MPF701"}),
    ("taint_through_module_chain", PROTO, """
     def read_share(store):
         return store.share

     def relabel(x):
         return x

     def report(store):
         log.warning("state", s=relabel(read_share(store)))
     """, {"MPL101", "MPF701"}),
    ("taint_through_closure", PROTO, """
     def outer(share):
         def fmt():
             return f"{share}"
         raise ValueError(fmt())
     """, {"MPF702"}),
    ("taint_through_comprehension", PROTO, """
     def dump(shares):
         lines = [f"{s}" for s in shares]
         log.info("all", lines=lines)
     """, {"MPF701"}),
    ("taint_through_dict", PROTO, """
     def stash(nonce):
         d = {}
         d["k"] = nonce
         log.debug("d", v=d["k"])
     """, {"MPF701"}),
    ("taint_to_wire", PROTO, """
     def leak(bus, seed):
         bus.publish("topic", {"seed": seed})
     """, {"MPF703"}),
    ("taint_to_file", PROTO, """
     import pickle
     def keep(path, share):
         path.write_bytes(share)
         pickle.dumps(share)
     """, {"MPF703"}),
    ("secret_param_annotation", PROTO, """
     from mpcium_tpu.utils.annotations import Secret

     def load() -> Secret[bytes]:
         return b""

     def use(blob: "Secret[bytes]"):
         log.info("use", b=blob, c=load())
     """, {"MPF701"}),
    ("hash_sanitizer", PROTO, """
     import hashlib

     def fingerprint(share):
         digest = hashlib.sha256(share).hexdigest()
         log.info("fp", fp=digest)
     """, set()),
    ("seal_sanitizer", PROTO, """
     def persist(kv, share, path):
         blob = kv.seal(share)
         path.write_bytes(blob)
     """, set()),
    ("declassified", PROTO, """
     def reveal(share):
         delta = (share + 1) % 7  # mpcflow: declassified — the R3 reveal
         log.info("delta", d=delta)
     """, set()),
    ("undeclassified", PROTO, """
     def reveal(share):
         delta = (share + 1) % 7
         log.info("delta", d=delta)
     """, {"MPF701"}),
    ("public_attrs", PROTO, """
     def announce(share):
         log.info("done", wallet=share.wallet_id, n=share.threshold)
     """, {"MPL101"}),
    ("fault_seeds_are_public", "faults/chaos.py", """
     def drill(seed):
         raise ValueError(f"drill seed {seed}")
     """, {"MPL102"}),
    ("analysis_package_is_skipped", "analysis/snippet.py", """
     def f(share):
         raise ValueError(f"{share}")
     """, {"MPL102"}),
]


@pytest.mark.parametrize("rel,src,expect", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_both_analyzers_agree(rel, src, expect):
    jax_found = _analyze(JAX_SIDE, rel, src)
    port_found = _analyze(PORT_SIDE, rel, src)
    # the snippet exercises what it names (so an agreement is not vacuous)
    assert {f.rule for f in jax_found} == expect
    assert _unprefixed(port_found, PORT) == _unprefixed(jax_found, JAX)


def test_every_rule_of_the_port_is_covered():
    covered = {rule for *_rest, expect in CASES for rule in expect}
    port_rules = {r.id for r in pt_rules.all_rules()}
    assert port_rules | {"MPF701", "MPF702", "MPF703"} <= covered


# -- residency: a JAX snippet and its torch translation ----------------------

RES = "engine/snippet_res.py"
# the port's kinds under JAX's names (x.cpu() is JAX's jax.device_get, ...)
KIND_MAP = {"cpu": "device_get", "to_cpu": "device_get", "numpy": "device_get",
            "synchronize": "block_until_ready"}

RES_PAIRS = [
    ("device_get_is_cpu", """
     import jax
     import jax.numpy as jnp
     def run_phase(x_d):
         y = jnp.add(x_d, 1)
         return jax.device_get(y)
     """, """
     import torch
     def run_phase(x_d):
         y = torch.add(x_d, 1)
         return y.cpu()
     """),
    ("device_get_is_to_cpu", """
     import jax
     def run_phase(x):
         return jax.device_get(x)
     """, """
     def run_phase(x):
         return x.to("cpu")
     """),
    ("device_get_is_numpy", """
     import jax
     def run_phase(x):
         return jax.device_get(x)
     """, """
     def run_phase(x):
         return x.numpy()
     """),
    ("cpu_then_numpy_is_one_transfer", """
     import jax
     def run_phase(x):
         return jax.device_get(x)
     """, """
     def run_phase(x):
         return x.cpu().numpy()
     """),
    ("block_until_ready_is_cuda_synchronize", """
     def run_phase(x):
         x.block_until_ready()
         return x
     """, """
     import torch
     def run_phase(x):
         torch.cuda.synchronize(x.device)
         return x
     """),
    ("block_until_ready_is_event_synchronize", """
     def run_phase(x):
         x.block_until_ready()
     """, """
     import torch
     def run_phase(x):
         ev = torch.cuda.Event()
         ev.record()
         ev.synchronize()
     """),
    ("item", """
     def run_phase(x):
         return x.item()
     """, """
     def run_phase(x):
         return x.item()
     """),
    ("np_asarray_of_a_device_value", """
     import jax.numpy as jnp
     import numpy as np
     def run_phase(x_d):
         y = jnp.add(x_d, 1)
         return np.asarray(y), np.asarray([1, 2])
     """, """
     import numpy as np
     import torch
     def run_phase(x_d):
         y = torch.add(x_d, 1)
         return np.asarray(y), np.asarray([1, 2])
     """),
    ("tolist_and_scalars", """
     import jax.numpy as jnp
     def run_phase(x_d, n):
         y = jnp.sum(x_d)
         return y.tolist(), bool(y), int(y), float(y), int(n), n.tolist()
     """, """
     import torch
     def run_phase(x_d, n):
         y = torch.sum(x_d)
         return y.tolist(), bool(y), int(y), float(y), int(n), n.tolist()
     """),
    ("device_returning_project_function", """
     import jax
     import numpy as np
     @jax.jit
     def kernel(x):
         return x
     def run_phase(x):
         y = kernel(x)
         return np.asarray(y)
     """, """
     import numpy as np
     import torch
     def kernel(x) -> torch.Tensor:
         return x
     def run_phase(x):
         y = kernel(x)
         return np.asarray(y)
     """),
    ("device_annotated_param", """
     import jax.numpy as jnp
     def run_phase(x: jnp.ndarray, h):
         return bool(x), bool(h)
     """, """
     import torch
     def run_phase(x: torch.Tensor, h):
         return bool(x), bool(h)
     """),
    ("method_of_a_device_value", """
     import jax.numpy as jnp
     import numpy as np
     def run_phase(x_d):
         y = jnp.add(x_d, 1).reshape(-1)
         return np.asarray(y.T)
     """, """
     import numpy as np
     import torch
     def run_phase(x_d):
         y = torch.add(x_d, 1).reshape(-1)
         return np.asarray(y.T)
     """),
    ("host_ok_on_the_line_and_above", """
     import jax
     def run_phase(x_d, y_d):
         a = jax.device_get(x_d)  # mpcflow: host-ok — wire egress for the test
         # mpcflow: host-ok — the verdict gates the protocol
         b = y_d.item()
         return a, b, x_d.item()
     """, """
     def run_phase(x_d, y_d):
         a = x_d.cpu()  # mpcflow: host-ok — wire egress for the test
         # mpcflow: host-ok — the verdict gates the protocol
         b = y_d.item()
         return a, b, x_d.item()
     """),
    ("reaches_through_the_call_graph", """
     import jax.numpy as jnp
     import numpy as np
     def run_phase(x_d):
         return _drain(jnp.multiply(x_d, x_d))
     def _drain(y_d):
         z = y_d + 1
         return np.asarray(z), bool(z)
     """, """
     import numpy as np
     import torch
     def run_phase(x_d):
         return _drain(torch.mul(x_d, x_d))
     def _drain(y_d):
         z = y_d + 1
         return np.asarray(z), bool(z)
     """),
    ("cold_function_is_not_scanned", """
     import jax.numpy as jnp
     import numpy as np
     def run_phase(x_d):
         return x_d
     def offline_tool(x_d):
         return np.asarray(jnp.add(x_d, 1)), x_d.item()
     """, """
     import numpy as np
     import torch
     def run_phase(x_d):
         return x_d
     def offline_tool(x_d):
         return np.asarray(torch.add(x_d, 1)), x_d.item()
     """),
]


def _residency(side, src: str, monkeypatch):
    pkg, core, _rules, flow = side
    res = jax_res if pkg == JAX else pt_res
    path = f"{pkg}/{RES}"
    monkeypatch.setattr(res, "PHASE_ENTRY_POINTS", {"test.phase": (f"{path}::run_phase",)})
    pf = core.ParsedFile(Path(path), path, textwrap.dedent(src))
    index = flow.ProjectIndex([pf])
    findings, sites = res.run_residency(index, flow.CallGraph(index))
    return findings, sites


@pytest.mark.parametrize("jax_src,torch_src", [p[1:] for p in RES_PAIRS],
                         ids=[p[0] for p in RES_PAIRS])
def test_residency_pairs_agree(jax_src, torch_src, monkeypatch):
    jf, js = _residency(JAX_SIDE, jax_src, monkeypatch)
    pf, ps = _residency(PORT_SIDE, torch_src, monkeypatch)

    def rows(sites):
        return sorted((KIND_MAP.get(s.kind, s.kind), s.symbol, s.intentional, s.reason)
                      for s in sites)

    assert rows(ps) == rows(js)
    assert len(pf) == len(jf) == sum(not s.intentional for s in js)
    assert {f.rule for f in pf} <= {"MPF801"}
    # the budget rows carry the same counts
    jb, pb = jax_flow.build_budget(js)["phases"], pt_flow.build_budget(ps)["phases"]
    strip = lambda b: {k: {c: v[c] for c in ("total_sites", "intentional", "tracked")}  # noqa: E731
                       for k, v in b.items()}
    assert strip(pb) == strip(jb)


def test_the_residency_pairs_cover_every_row_of_the_table(monkeypatch):
    kinds = set()
    for _name, _jax_src, torch_src in RES_PAIRS:
        kinds |= {s.kind for s in _residency(PORT_SIDE, torch_src, monkeypatch)[1]}
    assert kinds == {"cpu", "to_cpu", "numpy", "synchronize", "item", "np.asarray",
                     "tolist", "bool()", "int()", "float()"}


# -- the port's own residency rules ------------------------------------------


def test_a_host_helper_counts_at_each_call_site(monkeypatch):
    # JAX inlines np.asarray at every wire field; the port wraps it in a
    # helper, so the helper's callers carry the sites (and their reasons)
    _f, sites = _residency(PORT_SIDE, """
     import torch
     def _host(t: torch.Tensor):
         return t.cpu().numpy()
     def run_phase(u, v, w):
         out = {"u": _host(u)}  # mpcflow: host-ok — wire bytes

         out["v"] = _host(v)
         return out, u + w
     """, monkeypatch)
    assert sorted((s.symbol, s.kind, s.detail, s.intentional) for s in sites) == [
        ("run_phase", "_host()", "u", True), ("run_phase", "_host()", "v", False)]


def test_cohort_closures_of_a_hot_function_are_hot(monkeypatch):
    # the engines hand their cohort jobs to a runner instead of calling
    # them by name; a comprehension over the device pieces stays tracked
    _f, sites = _residency(PORT_SIDE, """
     import torch
     def step(x) -> torch.Tensor:
         return x
     def run_phase(xs, runner):
         def job():
             pieces = [step(x) for x in xs]
             return all(bool(p) for p in pieces)
         return runner([job])
     """, monkeypatch)
    assert [(s.symbol, s.kind, s.detail) for s in sites] == [("run_phase.job", "bool()", "p")]


def test_tensor_metadata_is_not_a_sync(monkeypatch):
    _f, sites = _residency(PORT_SIDE, """
     import torch
     def run_phase(x: torch.Tensor):
         return int(x.shape[0]), int(x.size(0)), int(x.numel()), str(x.device), int(x[0])
     """, monkeypatch)
    assert [(s.kind, s.detail) for s in sites] == [("int()", "x[]")]


# -- the baseline and the CLI -------------------------------------------------


def test_baseline_split_and_fail_closed(tmp_path):
    for mod in (jax_baseline, pt_baseline):
        Finding = (jax_core if mod is jax_baseline else pt_core).Finding
        f1 = Finding("MPL101", "a.py", 1, "f", "share", "m")
        f2 = Finding("MPF801", "b.py", 2, "g", "item:x", "m")
        b = mod.Baseline(path=tmp_path / "b.json", entries={
            f1.fingerprint: "grandfathered on purpose",
            "MPF801:c.py:h:item:y": "deleted by a ROADMAP item"})
        new, grandfathered, stale = b.split([f1, f2])
        assert (new, grandfathered, stale) == ([f2], [f1], ["MPF801:c.py:h:item:y"])
        # a one-family runner does not call the other family's entries stale
        assert b.split([f1], scope=("MPL",))[2] == []
        # saved and loaded back, the entries survive; blank reasons refuse
        b.save()
        assert mod.load_baseline(tmp_path / "b.json").entries == b.entries
        (tmp_path / "bad.json").write_text(json.dumps({"version": 1, "entries": [
            {"fingerprint": "MPL1:a::k", "justification": "  "}]}))
        with pytest.raises(mod.BaselineError):
            mod.load_baseline(tmp_path / "bad.json")
        assert mod.load_baseline(tmp_path / "none.json").entries == {}


def test_the_port_baseline_keeps_the_jax_schema():
    root = Path(__file__).resolve().parents[1]
    ours = json.loads((root / pt_baseline.DEFAULT_BASELINE).read_text())
    theirs = json.loads((root / jax_baseline.DEFAULT_BASELINE).read_text())
    assert ours.keys() == theirs.keys() and ours["version"] == theirs["version"]
    assert {k for e in ours["entries"] for k in e} == {"fingerprint", "justification"}


def test_cli_exit_codes(tmp_path, capsys):
    clean, dirty = tmp_path / "clean.py", tmp_path / "dirty.py"
    clean.write_text("def f(x):\n    return x\n")
    dirty.write_text("def f():\n    try:\n        pass\n    except:\n        pass\n")
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    empty = tmp_path / "empty.json"
    for main in (jax_cli.main, pt_cli.main):
        assert main([str(clean), "--baseline", str(empty)]) == 0
        assert main([str(dirty), "--no-baseline"]) == 1
        assert main([str(dirty), "--baseline", str(bad)]) == 2
        # --write-baseline grandfathers the sweep; the gate then passes
        assert main([str(dirty), "--write-baseline", "--baseline", str(empty)]) == 0
        assert main([str(dirty), "--baseline", str(empty)]) == 0
        empty.unlink()
    capsys.readouterr()
