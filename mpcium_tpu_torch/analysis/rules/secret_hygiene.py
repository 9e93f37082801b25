"""MPL1xx — secret hygiene.

Targets the failure mode SECURITY.md's secret-handling section worries
about: key shares, WAL AEAD keys, OT pads, signing nonces or identity
private keys reaching a log line, an exception string (tracebacks get
shipped to log aggregators), or a timing-unsafe comparison.

MPL101  secret identifier flows into a logging call
MPL102  secret identifier interpolated into a raised exception message
MPL103  == / != on compare-sensitive material (use hmac.compare_digest)
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from ..core import Finding, LintContext, ParsedFile, Rule, dotted_name
from ..taxonomy import is_compare_sensitive, is_secret_name

_LOG_FUNCS = {
    "debug",
    "info",
    "warn",
    "warning",
    "error",
    "fatal",
    "critical",
    "exception",
    "log",
}
_LOG_OBJECTS = {"log", "logger", "logging", "_logger"}


def _is_log_call(call: ast.Call) -> bool:
    f = call.func
    if not isinstance(f, ast.Attribute) or f.attr not in _LOG_FUNCS:
        return False
    root = f.value
    # log.info(...), self.log.info(...), mpcium_tpu_torch.utils.log.info(...)
    name = dotted_name(root)
    last = name.rsplit(".", 1)[-1] if name else ""
    return last in _LOG_OBJECTS


def _secret_names_in(node: ast.AST, extra: Set[str]) -> Iterator[ast.AST]:
    """Yield Name/Attribute nodes under ``node`` whose identifier is
    secret. ``x.hex()`` / ``repr(x)`` / f-string wrappers are walked
    through naturally by ast.walk."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and is_secret_name(sub.id, extra):
            yield sub
        elif isinstance(sub, ast.Attribute) and is_secret_name(sub.attr, extra):
            yield sub


class SecretToLog(Rule):
    id = "MPL101"
    summary = "secret material must not flow into logging calls"

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        extra = pf.extra_secrets
        for node in ast.walk(pf.tree):
            if not (isinstance(node, ast.Call) and _is_log_call(node)):
                continue
            exprs = list(node.args) + [kw.value for kw in node.keywords]
            # a secret-named KEYWORD with a benign value is still a leak
            # vector (log.info("x", share=len(s)) is fine; share=s is not)
            # — only the value expression decides.
            hit_names: Set[str] = set()
            for e in exprs:
                for s in _secret_names_in(e, extra):
                    ident = s.id if isinstance(s, ast.Name) else s.attr
                    hit_names.add(ident)
            for ident in sorted(hit_names):
                yield Finding(
                    rule=self.id,
                    path=pf.rel,
                    line=node.lineno,
                    symbol=pf.symbol_of(node),
                    key=ident,
                    message=(
                        f"secret {ident!r} reaches a log call — log a "
                        f"length/digest or drop it (taxonomy: "
                        f"analysis/taxonomy.py)"
                    ),
                )


class SecretInException(Rule):
    id = "MPL102"
    summary = "secret material must not be interpolated into exceptions"

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        extra = pf.extra_secrets
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            if not isinstance(exc, ast.Call):
                continue
            hit: Set[str] = set()
            for arg in list(exc.args) + [kw.value for kw in exc.keywords]:
                # only interpolation leaks: f-strings, str()/repr()/format
                # wrappers, % / + composition. A bare secret positional
                # arg also leaks via str(exc).
                for s in _secret_names_in(arg, extra):
                    hit.add(s.id if isinstance(s, ast.Name) else s.attr)
            for ident in sorted(hit):
                yield Finding(
                    rule=self.id,
                    path=pf.rel,
                    line=node.lineno,
                    symbol=pf.symbol_of(node),
                    key=ident,
                    message=(
                        f"secret {ident!r} interpolated into a raised "
                        f"exception — tracebacks end up in logs"
                    ),
                )


class SecretCompare(Rule):
    id = "MPL103"
    summary = "secret/MAC comparison must use hmac.compare_digest"

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        extra = pf.extra_secrets
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
                continue
            sides = [node.left] + list(node.comparators)
            # `x is None`-adjacent shapes and length checks don't count:
            # only flag when a *sensitive-named* operand is compared to
            # another non-constant expression
            sensitive = None
            other_nonconst = False
            for s in sides:
                ident = ""
                if isinstance(s, ast.Name):
                    ident = s.id
                elif isinstance(s, ast.Attribute):
                    ident = s.attr
                if ident and is_compare_sensitive(ident, extra):
                    sensitive = ident
                elif not isinstance(s, ast.Constant):
                    other_nonconst = True
            if sensitive and other_nonconst:
                yield Finding(
                    rule=self.id,
                    path=pf.rel,
                    line=node.lineno,
                    symbol=pf.symbol_of(node),
                    key=sensitive,
                    message=(
                        f"timing-unsafe == / != on {sensitive!r} — use "
                        f"hmac.compare_digest for secret/MAC bytes"
                    ),
                )
