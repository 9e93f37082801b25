"""Fail-closed finding baseline (the port's copy of the JAX package's
``analysis/baseline.py``, over its own file
``mpcium_tpu_torch/data/mpclint_baseline.json``).

Grandfathered findings live in a checked-in JSON file; each entry is a
fingerprint plus a one-line justification. The contract is **fail
closed both ways**:

- a finding NOT in the baseline fails the gate (new debt is refused);
- a baseline entry whose finding no longer fires ALSO fails the gate
  (the entry is stale — delete it), so the baseline only ever shrinks.

Fingerprints are line-number-free (see :class:`~.core.Finding`), so
unrelated edits to a file don't churn the baseline.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .core import Finding

DEFAULT_BASELINE = "mpcium_tpu_torch/data/mpclint_baseline.json"


class BaselineError(Exception):
    pass


@dataclass
class Baseline:
    path: Path
    entries: Dict[str, str] = field(default_factory=dict)  # fp -> justification

    def split(
        self,
        findings: Sequence[Finding],
        scope: Optional[Tuple[str, ...]] = None,
    ):
        """Partition a sweep against this baseline.

        Returns ``(new, grandfathered, stale)`` where ``new`` are
        findings with no baseline entry, ``grandfathered`` are matched
        findings, and ``stale`` are baseline fingerprints that matched
        nothing (each one must be deleted from the file).

        The baseline is shared between mpclint (MPL) and mpcflow (MPF);
        a runner that only executed one analyzer passes ``scope`` (rule
        prefixes it actually ran) so the other family's entries aren't
        reported stale. The combined gate (scripts/torch_check_all.py) passes
        no scope and enforces staleness over everything."""
        fps = {f.fingerprint for f in findings}
        new = [f for f in findings if f.fingerprint not in self.entries]
        grandfathered = [f for f in findings if f.fingerprint in self.entries]
        stale = sorted(
            fp
            for fp in self.entries
            if fp not in fps and (scope is None or fp.startswith(scope))
        )
        return new, grandfathered, stale

    def save(self) -> None:
        payload = {
            "version": 1,
            "entries": [
                {"fingerprint": fp, "justification": just}
                for fp, just in sorted(self.entries.items())
            ],
        }
        self.path.write_text(json.dumps(payload, indent=1) + "\n")


def load_baseline(path: Path) -> Baseline:
    """Load (or start empty when the file doesn't exist yet). Malformed
    files raise — a silently-ignored baseline would un-gate the repo."""
    if not path.exists():
        return Baseline(path=path)
    try:
        d = json.loads(path.read_text())
        entries: Dict[str, str] = {}
        for e in d["entries"]:
            fp, just = e["fingerprint"], e["justification"].strip()
            if not just:
                raise BaselineError(
                    f"baseline entry {fp!r} has no justification"
                )
            if fp in entries:
                raise BaselineError(f"duplicate baseline entry {fp!r}")
            entries[fp] = just
    except BaselineError:
        raise
    except Exception as e:
        raise BaselineError(f"cannot parse baseline {path}: {e!r}") from e
    return Baseline(path=path, entries=entries)


def write_baseline(path: Path, findings: List[Finding], justification: str) -> Baseline:
    """--write-baseline support: grandfather the current sweep wholesale
    (every entry gets the same placeholder justification, meant to be
    hand-edited before commit)."""
    b = Baseline(path=path)
    for f in findings:
        b.entries.setdefault(f.fingerprint, justification or f.message)
    b.save()
    return b
