"""The statistical perf-regression gate: honest about noise (the port's
copy of the JAX package's ``perf/statcheck.py``, stdlib only).

A micro-bench sample is a noisy draw; a gate that compares two means
fails on a busy box and passes a real 20% regression on a quiet one.
This module gates the way the accelerator-crypto literature reports
numbers: a one-sided Mann-Whitney U test (does the current distribution
stochastically dominate — run slower than — the baseline?) combined
with a practical-effect floor (the median ratio must exceed
``min_ratio``) and a seeded bootstrap confidence interval on that ratio
(its lower bound must clear 1.0). All three must agree before the gate
fails, which keeps the false-positive rate on identical distributions
under alpha while an injected 1.5× slowdown at n=30 fails.

The normal approximation with tie correction covers n ≥ ~8 per side.
Bootstrap resampling uses ``random.Random(seed)`` — deterministic,
replayable verdicts.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

DEFAULT_ALPHA = 0.01
DEFAULT_MIN_RATIO = 1.25  # practical-effect floor: <25% slower never fails
DEFAULT_BOOT_ITERS = 800


def _phi(z: float) -> float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        raise ValueError("median of empty sample")
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def mann_whitney_p(baseline: Sequence[float],
                   current: Sequence[float]) -> float:
    """One-sided p-value for H1 "current is stochastically greater
    (slower) than baseline", normal approximation with tie correction
    and continuity correction. Degenerate spreads (all values tied)
    return 1.0 — indistinguishable is not a regression."""
    n1, n2 = len(baseline), len(current)
    if n1 == 0 or n2 == 0:
        raise ValueError("mann_whitney_p needs non-empty samples")
    pooled = [(v, 0) for v in baseline] + [(v, 1) for v in current]
    pooled.sort(key=lambda t: t[0])
    # midranks with tie groups
    ranks = [0.0] * len(pooled)
    tie_term = 0.0
    i = 0
    while i < len(pooled):
        j = i
        while j + 1 < len(pooled) and pooled[j + 1][0] == pooled[i][0]:
            j += 1
        rank = (i + j + 2) / 2.0  # ranks are 1-based
        for k in range(i, j + 1):
            ranks[k] = rank
        t = j - i + 1
        tie_term += t * t * t - t
        i = j + 1
    r2 = sum(r for r, (_v, side) in zip(ranks, pooled) if side == 1)
    u2 = r2 - n2 * (n2 + 1) / 2.0  # U statistic for "current greater"
    mean = n1 * n2 / 2.0
    n = n1 + n2
    var = (n1 * n2 / 12.0) * ((n + 1) - tie_term / (n * (n - 1)))
    if var <= 0.0:
        return 1.0
    z = (u2 - mean - 0.5) / math.sqrt(var)
    return 1.0 - _phi(z)


def bootstrap_ratio_ci(
    baseline: Sequence[float],
    current: Sequence[float],
    iters: int = DEFAULT_BOOT_ITERS,
    seed: int = 0,
    lo_q: float = 0.025,
    hi_q: float = 0.975,
) -> Tuple[float, float]:
    """Seeded bootstrap CI of median(current)/median(baseline)."""
    rng = random.Random(seed)
    b, c = list(baseline), list(current)
    ratios = []
    for _ in range(iters):
        rb = [b[rng.randrange(len(b))] for _ in b]
        rc = [c[rng.randrange(len(c))] for _ in c]
        mb = median(rb)
        ratios.append(median(rc) / mb if mb > 0 else float("inf"))
    ratios.sort()
    lo = ratios[min(len(ratios) - 1, int(lo_q * len(ratios)))]
    hi = ratios[min(len(ratios) - 1, int(hi_q * len(ratios)))]
    return (lo, hi)


@dataclass
class Verdict:
    bench: str
    regressed: bool
    p_value: float
    ratio: float  # median(current)/median(baseline); >1 = slower
    ci: Tuple[float, float]
    baseline_median: float
    current_median: float
    note: str = ""

    def render(self) -> str:
        mark = "REGRESSION" if self.regressed else "ok"
        line = (
            f"{self.bench}: {mark} — median "
            f"{self.baseline_median * 1e3:.3f}ms → "
            f"{self.current_median * 1e3:.3f}ms "
            f"(ratio {self.ratio:.3f}, p={self.p_value:.2e}, "
            f"95% CI [{self.ci[0]:.3f}, {self.ci[1]:.3f}])"
        )
        return line + (f" [{self.note}]" if self.note else "")


def compare(
    bench: str,
    baseline: Sequence[float],
    current: Sequence[float],
    alpha: float = DEFAULT_ALPHA,
    min_ratio: float = DEFAULT_MIN_RATIO,
    boot_iters: int = DEFAULT_BOOT_ITERS,
    seed: int = 0,
) -> Verdict:
    """The gate for one bench: regression iff the rank test, the effect
    floor, AND the bootstrap CI all say slower."""
    bm, cm = median(baseline), median(current)
    ratio = cm / bm if bm > 0 else float("inf")
    p = mann_whitney_p(baseline, current)
    ci = bootstrap_ratio_ci(baseline, current, iters=boot_iters, seed=seed)
    regressed = p < alpha and ratio >= min_ratio and ci[0] > 1.0
    return Verdict(
        bench=bench, regressed=regressed, p_value=p, ratio=ratio, ci=ci,
        baseline_median=bm, current_median=cm,
    )


@dataclass
class GateResult:
    verdicts: List[Verdict] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def regressions(self) -> List[Verdict]:
        return [v for v in self.verdicts if v.regressed]

    @property
    def ok(self) -> bool:
        return not self.regressions


def gate(
    baselines: Dict[str, Sequence[float]],
    currents: Dict[str, Sequence[float]],
    alpha: float = DEFAULT_ALPHA,
    min_ratio: float = DEFAULT_MIN_RATIO,
    seed: int = 0,
) -> GateResult:
    """Compare every bench present in BOTH dicts; benches only on one
    side are reported as notes, never silently skipped (no silent caps)."""
    result = GateResult()
    for name in sorted(set(baselines) | set(currents)):
        if name not in baselines:
            result.notes.append(f"{name}: no committed baseline — skipped")
            continue
        if name not in currents:
            result.notes.append(f"{name}: not measured this run — skipped")
            continue
        result.verdicts.append(compare(
            name, baselines[name], currents[name],
            alpha=alpha, min_ratio=min_ratio, seed=seed,
        ))
    return result
