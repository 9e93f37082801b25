"""The port's flight recorder and Chrome-trace export (``trace/``), as
``tests/test_trace_export.py`` and the recorder cases of
``tests/test_tracing.py`` check the JAX package's. Every document the
port exports must pass both packages' ``validate_chrome``, and the same
spans export to the same document in both packages."""
from __future__ import annotations

import json

import pytest

from mpcium_tpu.trace import chrome_trace as jax_chrome_trace
from mpcium_tpu.trace import validate_chrome as jax_validate

from mpcium_tpu_torch.trace import (
    TraceSchemaError,
    arm,
    armed,
    chrome_trace,
    disarm,
    recorder,
    snapshot_chrome,
    validate_chrome,
)
from mpcium_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    recorder.reset()
    recorder.set_dump_dir(None)
    yield
    tracing.disable()
    recorder.reset()
    recorder.set_dump_dir(None)


def _span(name, node, tid, t0, t1, **attrs):
    return {
        "name": name, "trace_id": "t" * 16, "span_id": "s1",
        "parent_id": None, "node": node, "tid": tid,
        "t0_ns": t0, "t1_ns": t1, "kind": "X",
        "attrs": attrs,
    }


def _both_valid(doc) -> int:
    n = validate_chrome(doc)
    assert jax_validate(doc) == n
    return n


def test_chrome_trace_merges_nodes_with_pid_per_node():
    per_node = {
        "node0": ([_span("session", "node0", "sess-1", 1000, 5000)], 0),
        "node1": ([_span("session", "node1", "sess-1", 2000, 6000)], 3),
    }
    doc = chrome_trace(per_node, meta={"drill": "kill-resume"})
    assert _both_valid(doc) == len(doc["traceEvents"])
    assert doc == jax_chrome_trace(per_node, meta={"drill": "kill-resume"})
    procs = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert set(procs) == {"node0", "node1"} and len(set(procs.values())) == 2
    threads = [e["args"]["name"] for e in doc["traceEvents"]
               if e["ph"] == "M" and e["name"] == "thread_name"]
    assert threads == ["sess-1", "sess-1"]
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert min(e["ts"] for e in xs) == 0.0
    assert doc["otherData"]["dropped_spans"] == {"node0": 0, "node1": 3}
    assert doc["otherData"]["drill"] == "kill-resume"


def test_chrome_trace_args_carry_span_identity():
    parent = _span("outer", "node0", "s", 0, 10)
    child = dict(_span("inner", "node0", "s", 2, 8), parent_id="p9", span_id="s2")
    doc = chrome_trace({"node0": ([parent, child], 0)})
    inner = next(e for e in doc["traceEvents"] if e.get("name") == "inner")
    assert inner["args"]["parent_id"] == "p9"
    assert inner["args"]["trace_id"] == "t" * 16
    _both_valid(doc)


def test_snapshot_chrome_from_live_recorders():
    arm(node_ids=["node0", "node1"])
    assert armed()
    with tracing.span("session", trace_id="abc", node="node0", tid="sess-9"):
        with tracing.span("round:r1", node="node0", tid="sess-9"):
            pass
    tracing.instant("intake", node="node1", tid="lane:bulk")
    doc = snapshot_chrome(meta={"soak_seed": 1})
    _both_valid(doc)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"session", "round:r1", "intake"} <= names
    assert doc["otherData"]["soak_seed"] == 1
    round_ = next(e for e in doc["traceEvents"] if e["name"] == "round:r1")
    session = next(e for e in doc["traceEvents"] if e["name"] == "session")
    assert round_["args"]["parent_id"] == session["args"]["span_id"]
    disarm()
    assert not armed()
    assert snapshot_chrome(node_ids=["node1"])["otherData"]["dropped_spans"] == {"node1": 0}


def test_schema_rejects_malformed_documents():
    with pytest.raises(TraceSchemaError):
        validate_chrome([])
    with pytest.raises(TraceSchemaError):
        validate_chrome({"traceEvents": "nope"})
    with pytest.raises(TraceSchemaError, match="unknown ph"):
        validate_chrome({"traceEvents": [{"ph": "Z", "name": "x", "pid": 1}]})
    with pytest.raises(TraceSchemaError, match="dur"):
        validate_chrome({"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0}]})
    with pytest.raises(TraceSchemaError, match="ts"):
        validate_chrome({"traceEvents": [{"ph": "i", "name": "x", "pid": 1, "tid": 1, "ts": -1}]})


def test_schema_accepts_empty_trace():
    assert validate_chrome({"traceEvents": []}) == 0


def test_recorder_bounded_with_exact_dropped_count():
    rec = recorder.FlightRecorder("n0", capacity=8)
    for i in range(20):
        rec.record({"name": f"s{i}"})
    spans, dropped = rec.snapshot()
    assert len(spans) == 8 and dropped == 12 and spans[-1]["name"] == "s19"
    spans, dropped = rec.snapshot(clear=True)
    assert dropped == 12
    assert rec.snapshot() == ([], 0)


def test_record_routes_by_node_and_resets_named_nodes():
    recorder.record({"name": "a", "node": "node0"})
    recorder.record({"name": "b", "node": "node1"})
    recorder.record({"name": "c", "node": None})
    snap = recorder.snapshot_all()
    assert set(snap) == {"node0", "node1", "local"}
    assert snap["node0"][0][0]["name"] == "a"
    recorder.reset(["node0"])
    assert "node0" not in recorder.snapshot_all()


def test_incident_dump_is_bounded_and_valid(tmp_path):
    arm(dump_dir=str(tmp_path))
    for _ in range(recorder._DUMP_LIMIT + 5):
        tracing.incident("shed", node="node0", reason="backpressure")
    dumps = sorted(tmp_path.glob("trace_incident_*.json"))
    assert len(dumps) == recorder._DUMP_LIMIT
    doc = json.loads(dumps[0].read_text())
    _both_valid(doc)
    assert doc["otherData"]["incident"] == "shed"
    assert any(e["name"] == "incident:shed" for e in doc["traceEvents"])


def test_incident_dump_never_raises_on_bad_dir():
    arm(dump_dir="/proc/definitely/not/writable")
    tracing.incident("shed", node="node0")  # must not raise


def test_compile_entry_lands_on_the_timeline(tmp_path):
    """The compile ledger's span (node ``engine``, tid ``compile``) exports
    with the recorders, and the ledger file holds the entry."""
    from mpcium_tpu_torch.perf import compile_watch

    compile_watch.reset()
    try:
        arm()
        compile_watch.set_ledger_dir(str(tmp_path))
        entry = compile_watch.finish(compile_watch.begin("mulmod", "abc123"), "miss")
        assert compile_watch.begin("mulmod", "abc123") is None  # once per process
        doc = snapshot_chrome()
        _both_valid(doc)
        ev = next(e for e in doc["traceEvents"] if e["name"] == "compile:mulmod")
        assert ev["args"]["cache"] == "miss" and ev["args"]["shape"] == "abc123"
        ledger = json.loads((tmp_path / compile_watch.LEDGER_BASENAME).read_text())
        assert ledger["entries"] == [entry]
        assert entry["engine"] == "mulmod" and entry["platform"] == "cuda"
    finally:
        compile_watch.reset()
