"""mpcflow: interprocedural dataflow analysis for mpcium_tpu_torch.

Two analyses share one symbol table + call graph over the same
ParsedFile set mpclint uses (analysis/core.parse_project — parse once,
analyze twice):

- **MPF7xx** secret-flow taint (flow/taint.py): share-store reads, DKG
  outputs and nonce/PRG derivation must never reach logging, exception
  formatting, pickle/file writes, or unsealed wire payloads without
  passing an AEAD seal / hash commitment / explicit declassification.
  Findings carry the full source→sink call chain.
- **MPF8xx** device-residency (flow/residency.py): functions reachable
  from protocol-phase entry points are device-hot; host
  materializations of device tensors on those paths (each one makes
  the host wait for the card) are budgeted sites
  (mpcium_tpu_torch/data/host_transfer_budget.json) that must shrink,
  not grow.

Findings reuse mpclint's Finding/fingerprint/baseline machinery, so the
shared baseline (mpcium_tpu_torch/data/mpclint_baseline.json) and the
fail-closed-both-ways gate apply
unchanged.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from ..core import Finding, LintResult, ParsedFile, parse_project
from .callgraph import CallGraph
from .residency import Site, build_budget, run_residency
from .symbols import ProjectIndex
from .taint import run_taint

__all__ = [
    "CallGraph", "ProjectIndex", "Site", "build_budget",
    "run_flow", "run_flow_parsed",
]


def run_flow_parsed(
    files: Sequence[ParsedFile],
    parse_errors: Sequence[str] = (),
) -> Tuple[LintResult, List[Site]]:
    """Run both analyses over already-parsed files. Returns the combined
    LintResult (taint + residency findings) and the residency site list
    (for the budget)."""
    index = ProjectIndex(files)
    graph = CallGraph(index)
    findings: List[Finding] = list(run_taint(index, graph))
    res_findings, sites = run_residency(index, graph)
    findings.extend(res_findings)
    result = LintResult()
    result.files_scanned = len(files)
    result.parse_errors = list(parse_errors)
    result.findings = sorted(
        findings, key=lambda f: (f.path, f.line, f.rule, f.key)
    )
    return result, sites


def run_flow(
    paths: Optional[Sequence[Path]] = None,
    root: Optional[Path] = None,
) -> Tuple[LintResult, List[Site]]:
    """Parse + analyze (standalone entry point; the combined gate goes
    through scripts/torch_check_all.py to share the parse with mpclint)."""
    root = root or Path(__file__).resolve().parents[3]
    paths = list(paths) if paths else [root / "mpcium_tpu_torch"]
    files, errors = parse_project(paths, root=root)
    return run_flow_parsed(files, parse_errors=errors)
