"""Tier-1 static gate over the port: mpclint and mpcflow over the whole
of ``mpcium_tpu_torch`` (the counterpart of ``tests/test_mpclint.py``
and ``tests/test_mpcflow.py``, which gate the JAX package).

Any finding not in ``mpcium_tpu_torch/data/mpclint_baseline.json``
fails, any stale baseline entry fails, the committed
``mpcium_tpu_torch/data/host_transfer_budget.json`` must equal the
sweep, and the sweep must stay fast enough for tier-1. The tracked host
syncs — the Paillier proof batcher's host modexps — are asserted
exactly, so removing one or adding debt moves the baseline and ROADMAP
in the same commit.
"""
from __future__ import annotations

import ast
import json
import sys
import time
from pathlib import Path

import pytest

from mpcium_tpu_torch.analysis.baseline import DEFAULT_BASELINE, load_baseline
from mpcium_tpu_torch.analysis.core import ParsedFile, lint_parsed, parse_project
from mpcium_tpu_torch.analysis.flow import ProjectIndex, build_budget, run_flow_parsed
from mpcium_tpu_torch.analysis.flow.residency import PHASE_ENTRY_POINTS
from mpcium_tpu_torch.analysis.rules import all_rules

pytestmark = pytest.mark.lint

ROOT = Path(__file__).resolve().parents[1]
BUDGET_PATH = ROOT / "mpcium_tpu_torch" / "data" / "host_transfer_budget.json"
GG18 = "mpcium_tpu_torch/engine/gg18_batch.py"


def _sweep(files, parse_errors=()):
    lint = lint_parsed(files, all_rules(), parse_errors=parse_errors)
    flow, sites = run_flow_parsed(files, parse_errors=parse_errors)
    return lint, flow, sites


@pytest.fixture(scope="module")
def parsed():
    return parse_project([ROOT / "mpcium_tpu_torch"], root=ROOT)


@pytest.fixture(scope="module")
def sweep(parsed):
    files, errors = parsed
    t0 = time.monotonic()
    lint, flow, sites = _sweep(files, errors)
    return lint, flow, sites, time.monotonic() - t0


def test_port_parses_clean(sweep):
    lint, flow, _sites, _elapsed = sweep
    assert not lint.parse_errors and not flow.parse_errors, lint.parse_errors
    # the whole port is in scope, not a subset
    assert lint.files_scanned > 100 and flow.files_scanned > 100


def test_no_new_findings_no_stale_entries(sweep):
    lint, flow, _sites, _elapsed = sweep
    baseline = load_baseline(ROOT / DEFAULT_BASELINE)
    new, _grandfathered, stale = baseline.split(lint.findings + flow.findings)
    assert not new, "non-baselined findings:\n" + "\n".join(f.render() for f in new)
    assert not stale, (
        "stale baseline entries (delete them — the baseline only shrinks):\n"
        + "\n".join(stale)
    )


def test_no_taint_finding_fires_or_is_baselined(sweep):
    # every secret-flow hit in the port is fixed or declassified with a
    # reason on its line; none is grandfathered
    _lint, flow, _sites, _elapsed = sweep
    assert not [f.render() for f in flow.findings if f.rule.startswith("MPF7")]
    baseline = load_baseline(ROOT / DEFAULT_BASELINE)
    assert not [fp for fp in baseline.entries if fp.startswith("MPF7")]


def test_sweep_is_tier1_fast(sweep):
    *_rest, elapsed = sweep
    # ~12 s on one core for both analyzers; 30 s keeps it honest under load
    assert elapsed < 30, f"sweep took {elapsed:.1f}s"


def test_budget_matches_committed_json(sweep):
    *_rest, sites, _elapsed = sweep
    assert BUDGET_PATH.exists(), "run scripts/torch_mpcflow_budget.py"
    assert json.loads(BUDGET_PATH.read_text()) == build_budget(sites), (
        "host_transfer_budget.json drifted from the sweep — regenerate with "
        "scripts/torch_mpcflow_budget.py and review the diff"
    )


def test_every_phase_entry_point_resolves(parsed):
    files, _errors = parsed
    index = ProjectIndex(files)
    entries = [fid for fids in PHASE_ENTRY_POINTS.values() for fid in fids]
    assert len(entries) == 22
    assert [fid for fid in entries if fid not in index.functions] == []


def test_baseline_is_justified():
    baseline = load_baseline(ROOT / DEFAULT_BASELINE)
    assert baseline.entries
    for fp, justification in baseline.entries.items():
        assert fp.startswith(("MPL", "MPF")), fp
        assert fp.split(":")[1].startswith("mpcium_tpu_torch/"), fp
        assert len(justification) > 20, (fp, justification)
        if fp.startswith("MPF"):
            # debt names its exit: a wire boundary or the ROADMAP item
            assert "wire boundary" in justification or "ROADMAP" in justification, fp


def _tracked(budget, phase):
    return {
        (s["path"], s["symbol"], s["kind"], s["detail"])
        for s in budget["phases"].get(phase, {"sites": []})["sites"]
        if not s["intentional"]
    }


def test_budget_tracks_the_known_host_walls():
    budget = json.loads(BUDGET_PATH.read_text())
    # EdDSA's host syncs are all wire egress or the fraud verdict
    assert _tracked(budget, "eddsa.sign") == set()
    assert _tracked(budget, "ecdsa.mta_ot") == set()
    # the one remaining wall: the Paillier proof batcher's host modexps
    # x^N mod N^2 (ROADMAP Queue 2, B6)
    assert _tracked(budget, "ecdsa.sign") == {
        (GG18, "MtaBatch._alice_enc_leg", "_host_pow_single()", "Sp"),
        (GG18, "MtaBatch._alice_enc_leg_strict", "_host_pow_batch()", "bn.take_limbs"),
        (GG18, "MtaBatch.alice_check_bob", "_host_pow_single()", "Sp"),
        (GG18, "MtaBatch.alice_check_bob", "_host_pow_batch()", "s_lift"),
    }
    total = sum(ph["tracked"] for ph in budget["phases"].values())
    assert total == 4, f"tracked debt drifted: {total} != 4"


def test_tracked_debt_is_baselined_with_an_exit():
    budget = json.loads(BUDGET_PATH.read_text())
    baseline = load_baseline(ROOT / DEFAULT_BASELINE)
    for phase, ph in budget["phases"].items():
        for s in ph["sites"]:
            if s["intentional"]:
                assert s["reason"], (phase, s)
                continue
            fp = f"MPF801:{s['path']}:{s['symbol']}:{s['kind']}:{s['detail']}"
            assert fp in baseline.entries, f"tracked site not baselined: {fp} ({phase})"
            justification = baseline.entries[fp]
            assert "wire boundary" in justification or "ROADMAP" in justification, fp


def _insert(pf: ParsedFile, qualname: str, stmt: str) -> ParsedFile:
    """``pf`` with ``stmt`` as the first statement of ``qualname``."""
    scope = pf.tree
    for name in qualname.split("."):
        scope = next(n for n in ast.iter_child_nodes(scope)
                     if getattr(n, "name", None) == name)
    first = scope.body[0]
    lines = pf.source.splitlines(keepends=True)
    lines.insert(first.lineno - 1, " " * first.col_offset + stmt + "\n")
    return ParsedFile(pf.path, pf.rel, "".join(lines))


def test_an_injected_leak_and_host_sync_fail_the_gate(parsed):
    files, _errors = parsed
    by_rel = {pf.rel: pf for pf in files}
    eddsa = "mpcium_tpu_torch/protocol/eddsa/signing.py"
    by_rel[eddsa] = _insert(by_rel[eddsa], "EDDSASigningParty._round3",
                            'log.info("x", share=share)')
    by_rel[GG18] = _insert(by_rel[GG18], "GG18BatchCoSigners.sign", "t.item()")
    lint, flow, _sites = _sweep(list(by_rel.values()))
    new, _g, stale = load_baseline(ROOT / DEFAULT_BASELINE).split(
        lint.findings + flow.findings)
    assert not stale
    got = {(f.rule, f.path, f.symbol) for f in new}
    assert got == {
        ("MPL101", eddsa, "EDDSASigningParty._round3"),
        ("MPF701", eddsa, "EDDSASigningParty._round3"),
        ("MPF801", GG18, "GG18BatchCoSigners.sign"),
    }, sorted(got)


def test_gate_script_exits_zero_on_the_tree(capsys):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import torch_check_all
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert torch_check_all.main([]) == 0, capsys.readouterr().out
    assert "0 new" in capsys.readouterr().out


def test_the_gate_needs_neither_torch_nor_jax():
    # pure-stdlib ast code: the analysis package imports no third-party
    # module, so the gate runs wherever Python does
    pkg = ROOT / "mpcium_tpu_torch" / "analysis"
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in stdlib, (path.name, name)


def test_cli_agrees(capsys):
    from mpcium_tpu_torch.analysis.cli import main as mpclint_main

    assert mpclint_main([]) == 0
    assert mpclint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    ids = [line.split()[0] for line in out.strip().splitlines() if line.startswith("MPL")]
    # the JAX package's 14 rules less MPL401/MPL402
    assert len(ids) == len(set(ids)) == 12
    assert not any(i.startswith("MPL4") for i in ids)
