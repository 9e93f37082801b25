"""Rule plugin registry. A rule family is one module; adding a family =
adding a module here. The JAX package's MPL4xx family (host syncs and
traced branches inside ``jax.jit`` bodies) has no counterpart: the port
has no jitted bodies, and its host syncs are what MPF801 counts. Keep
construction cheap — the CLI and the tier-1 gate build a fresh rule set
per sweep (rules may hold cross-file state)."""
from __future__ import annotations

from typing import List

from ..core import Rule
from .determinism import DictOrderIteration, ForbiddenEntropyCall
from .hygiene import BareExcept, MutableDefaultArg, UnusedImport
from .lock_discipline import LockOrderInversion, UnguardedLockedField
from .secret_hygiene import SecretCompare, SecretInException, SecretToLog
from .wire_thread import UnmanagedThread, WireVersionRoundTrip


def all_rules() -> List[Rule]:
    return [
        SecretToLog(),
        SecretInException(),
        SecretCompare(),
        ForbiddenEntropyCall(),
        DictOrderIteration(),
        UnguardedLockedField(),
        LockOrderInversion(),
        WireVersionRoundTrip(),
        UnmanagedThread(),
        BareExcept(),
        MutableDefaultArg(),
        UnusedImport(),
    ]


def rule_catalog() -> List[Rule]:
    """Stable listing for ``mpclint --list-rules`` and the docs."""
    return all_rules()
