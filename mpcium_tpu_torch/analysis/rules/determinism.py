"""MPL2xx — determinism.

The fault DSL's replay guarantee (faults/plan.py: every probabilistic
decision is a pure PRF of seed/rule/message) and the WAL's bit-identical
resume (store/session_wal.py: checkpointed payloads are re-sent, never
re-derived) both collapse if protocol code consults ambient entropy or
wall-clock time, or lets dict iteration order pick who hears what first.

MPL201  time.time()/random.*/os.urandom inside decision paths
MPL202  dict-order iteration over a peer set (sort it)

Scope: ``faults/plan.py`` and everything under ``protocol/``. Protocol
randomness is legitimate at round *start* — but it must come from the
party's own seeded/checkpointed source, never from module-level
``random`` or wall-clock; ``secrets``-based key material generation
lives in keygen paths and is checkpointed before routing, so it is not
banned here (the WAL re-sends, it never re-derives).
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..core import Finding, LintContext, ParsedFile, Rule, dotted_name

_FORBIDDEN_CALLS = {
    "time.time": "wall-clock in a decision path breaks replay",
    "os.urandom": "ambient entropy breaks seed-determinism",
    "uuid.uuid4": "ambient entropy breaks seed-determinism",
}
_FORBIDDEN_ROOTS = {
    "random": "module-level random.* draws are interleaving-dependent",
    "np.random": "np.random.* draws are interleaving-dependent",
    "numpy.random": "np.random.* draws are interleaving-dependent",
}

_SCOPES = ("mpcium_tpu_torch/faults/plan.py", "mpcium_tpu_torch/protocol/")

# dict-named peer sets whose iteration order is a protocol decision
_PEERISH = {"peers", "participants", "parties", "members", "hellos", "peer_ids"}


def _in_scope(rel: str) -> bool:
    return rel.startswith(_SCOPES[1]) or rel == _SCOPES[0]


class ForbiddenEntropyCall(Rule):
    id = "MPL201"
    summary = "no wall-clock/ambient entropy in protocol/fault decision paths"

    def applies(self, rel: str) -> bool:
        return _in_scope(rel)

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if not name:
                continue
            why = _FORBIDDEN_CALLS.get(name)
            if why is None:
                for root, root_why in _FORBIDDEN_ROOTS.items():
                    if name.startswith(root + "."):
                        why = root_why
                        break
            if why is None:
                continue
            yield Finding(
                rule=self.id,
                path=pf.rel,
                line=node.lineno,
                symbol=pf.symbol_of(node),
                key=name,
                message=f"{name}() forbidden here: {why}",
            )


class DictOrderIteration(Rule):
    id = "MPL202"
    summary = "peer-set iteration must be sorted (dict order is a bug)"

    def applies(self, rel: str) -> bool:
        return _in_scope(rel)

    def _peerish_iter(self, it: ast.AST) -> str:
        """The peer-set identifier iterated over, or ''. `sorted(...)`
        wrappers make the iteration deterministic and pass."""
        target = it
        if isinstance(target, ast.Call):
            fname = dotted_name(target.func)
            if fname == "sorted" or fname.endswith(".sorted"):
                return ""
            # peers.keys() / parties.values() / parties.items()
            if isinstance(target.func, ast.Attribute) and target.func.attr in (
                "keys",
                "values",
                "items",
            ):
                target = target.func.value
            else:
                return ""
        if isinstance(target, ast.Name) and target.id in _PEERISH:
            return target.id
        if isinstance(target, ast.Attribute) and target.attr.lstrip("_") in _PEERISH:
            return target.attr
        return ""

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        for node in ast.walk(pf.tree):
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters = [node.iter]
            elif isinstance(
                node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
            ):
                iters = [g.iter for g in node.generators]
            for it in iters:
                ident = self._peerish_iter(it)
                if not ident:
                    continue
                yield Finding(
                    rule=self.id,
                    path=pf.rel,
                    line=getattr(it, "lineno", node.lineno),
                    symbol=pf.symbol_of(node),
                    key=ident,
                    message=(
                        f"iteration over peer set {ident!r} in dict order — "
                        f"wrap in sorted(...) so every member walks peers "
                        f"identically"
                    ),
                )
