"""Deterministic fault injection and chaos drills, the port's copy of the
JAX package's ``faults/``:

- :mod:`.plan` — declarative, seed-deterministic fault plans (drop /
  delay / duplicate / reorder / crash / partition / tamper rules with
  match predicates and per-rule PRF streams);
- :mod:`.transport` — a :class:`~.transport.FaultyTransport` decorator
  over any :class:`~..transport.api.Transport` that applies the active
  plan on publish/deliver, plus the node crash switch;
- :mod:`.chaos` — the drill runner: stands up an in-process cluster on a
  given device, executes keygen → signing → reshare under a plan, and
  emits a structured, reproducible drill report
  (``scripts/torch_chaos_drill.py``).
"""
from .plan import (  # noqa: F401
    FaultPlan,
    Rule,
    crash_node,
    delay,
    drop,
    duplicate,
    named_plan,
    partition,
    reorder,
    tamper,
)
from .transport import CrashSwitch, FaultStats, FaultyTransport  # noqa: F401
