"""Runtime-side mpclint/mpcflow annotations (zero-cost at runtime; the
port's copy of the JAX package's ``utils/annotations.py``).

``@locked_by(lock, *fields)`` declares which instance attributes a class
guards under which lock. mpclint's lock-discipline rule (MPL301) reads
the decorator *statically* and flags any write to a declared field that
is not inside ``with self.<lock>:`` (``__init__`` is exempt — objects
under construction are unpublished). At runtime the decorator only
records the declaration on the class, so annotated and unannotated
builds behave identically.

A method whose whole body runs under the lock (a helper only called from
locked contexts) is marked on its ``def`` line::

    def _checkpoint(self, out):  # mpclint: holds=_lock
        ...

See STATIC_ANALYSIS.md for the full registry.
"""
from __future__ import annotations

from typing import Callable, Dict, Generic, Tuple, TypeVar

T = TypeVar("T", bound=type)
_V = TypeVar("_V")


class Secret(Generic[_V]):
    """Type-annotation marker: the annotated value IS secret material,
    whatever its spelling. mpcflow reads it statically — a parameter or
    return annotated ``Secret[...]`` seeds the MPF7xx taint lattice at
    every call boundary::

        def load_share(self, ...) -> "Secret[KeygenShare]": ...
        def seal(self, plaintext: "Secret[bytes]") -> bytes: ...

    At runtime it is inert: ``Secret[bytes]`` is just ``bytes``, and
    nothing is instantiated. Use string-form annotations (as above)."""

    def __class_getitem__(cls, item):
        return item


# thread-name prefixes the tests' leak checker treats as process-lifetime
# singletons; MPL502 accepts threads named under them as "registered"
REGISTERED_THREAD_PREFIXES: Tuple[str, ...] = ("ot-host",)


def locked_by(lock: str, *fields: str) -> Callable[[T], T]:
    """Class decorator: ``fields`` may only be written while holding
    ``self.<lock>``. Stackable for classes with several locks."""

    def wrap(cls: T) -> T:
        reg: Dict[str, Tuple[str, ...]] = dict(
            getattr(cls, "__mpclint_locked_by__", {})
        )
        reg[lock] = tuple(dict.fromkeys(reg.get(lock, ()) + fields))
        cls.__mpclint_locked_by__ = reg  # type: ignore[attr-defined]
        return cls

    return wrap
