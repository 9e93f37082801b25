"""MPL6xx — general hygiene.

The three ruff-class defects this repo actually produces, enforced
natively so the gate needs no tool beyond the standard library:

MPL601  bare ``except:`` — swallows KeyboardInterrupt/SystemExit and
        masks faults the chaos drills are supposed to surface
MPL602  mutable default argument
MPL603  unused import (skipped for ``__init__.py`` re-export modules)
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Set

from ..core import Finding, LintContext, ParsedFile, Rule


class BareExcept(Rule):
    id = "MPL601"
    summary = "no bare except: clauses"

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield Finding(
                    rule=self.id,
                    path=pf.rel,
                    line=node.lineno,
                    symbol=pf.symbol_of(node),
                    key=f"L{node.lineno // 50}",  # coarse bucket, survives small drift
                    message=(
                        "bare 'except:' also catches KeyboardInterrupt/"
                        "SystemExit — name the exceptions (or 'except "
                        "Exception:' at worst)"
                    ),
                )


class MutableDefaultArg(Rule):
    id = "MPL602"
    summary = "no mutable default arguments"

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        for fn in ast.walk(pf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = fn.args
            pos = args.posonlyargs + args.args
            defaults = args.defaults
            pairs = list(zip(pos[len(pos) - len(defaults) :], defaults))
            pairs += [
                (a, d)
                for a, d in zip(args.kwonlyargs, args.kw_defaults)
                if d is not None
            ]
            for arg, default in pairs:
                bad = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(default, ast.Call)
                    and isinstance(default.func, ast.Name)
                    and default.func.id in ("list", "dict", "set", "bytearray")
                )
                if bad:
                    yield Finding(
                        rule=self.id,
                        path=pf.rel,
                        line=fn.lineno,
                        symbol=f"{pf.symbol_of(fn)}.{fn.name}".lstrip("."),
                        key=arg.arg,
                        message=(
                            f"mutable default for {arg.arg!r} is shared "
                            f"across calls — default to None and build "
                            f"inside"
                        ),
                    )


class UnusedImport(Rule):
    id = "MPL603"
    summary = "no unused imports"

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        if pf.rel.endswith("__init__.py"):  # re-export surface
            return
        imported: Dict[str, int] = {}  # bound name -> lineno
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name.split(".")[0]
                    imported[name] = node.lineno
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    imported[alias.asname or alias.name] = node.lineno
        if not imported:
            return
        used: Set[str] = set()
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                pass  # root Name is walked separately
        # names referenced in __all__ or in string annotations count
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                used.add(node.value)
        for name, lineno in sorted(imported.items()):
            if name in used:
                continue
            yield Finding(
                rule=self.id,
                path=pf.rel,
                line=lineno,
                symbol="",
                key=name,
                message=f"import {name!r} is unused",
            )
