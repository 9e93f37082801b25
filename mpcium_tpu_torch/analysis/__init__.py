"""mpclint and mpcflow over the port — the counterpart of the JAX
package's ``analysis/``, aimed at ``mpcium_tpu_torch``.

Pure-stdlib ``ast`` code: it imports neither torch nor JAX, and nothing
of the JAX package. It keeps:

- **mpclint**, the rule families MPL1xx (secret hygiene), MPL2xx
  (determinism in ``protocol/`` and ``faults/plan.py``), MPL3xx (lock
  discipline, ``@locked_by`` from ``utils/annotations.py``), MPL5xx
  (wire versions and thread hygiene) and MPL6xx (general hygiene);
- **mpcflow** (``flow/``), the MPF7xx secret-flow taint and the MPF8xx
  device-residency sweep, whose sites are torch's host syncs
  (``.cpu()``, ``.item()``, ``.tolist()``, ``torch.cuda.synchronize``,
  ``bool(t)``, …) on the protocol-hot paths, budgeted in
  ``mpcium_tpu_torch/data/host_transfer_budget.json``.

The JAX package's MPL4xx (``jax.jit`` hazards) and ``shape/`` (the
per-shape compile surface) have no counterpart: the port has no jitted
bodies and compiles no executable per shape.

Suppression syntax: ``# mpclint: disable=<rule> — reason`` on the line
or the line above, ``# mpclint: disable-file=<rule>`` in a file's first
15 lines, ``# mpcflow: declassified — what`` on an assignment, and
``# mpcflow: host-ok — reason`` on a host sync. Findings gate against
``mpcium_tpu_torch/data/mpclint_baseline.json``, fail-closed both ways
(``scripts/torch_check_all.py``).
"""
from __future__ import annotations

from .baseline import Baseline, BaselineError, load_baseline
from .core import Finding, LintContext, LintResult, lint_paths, run_lint

__all__ = [
    "Baseline",
    "BaselineError",
    "Finding",
    "LintContext",
    "LintResult",
    "lint_paths",
    "load_baseline",
    "run_lint",
]
