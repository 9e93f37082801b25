"""MPL3xx — lock discipline.

PR 4 found two latent session races by *drilling*; this family finds the
shape statically:

MPL301  a field declared ``@locked_by("_lock", "_started", ...)`` is
        written outside ``with self._lock:`` (the ``_started``
        publish-before-start race is exactly this shape). ``__init__``
        is exempt (unpublished object); helper methods whose whole body
        runs under the lock are marked ``# mpclint: holds=_lock`` on
        their ``def`` line.
MPL302  the package-wide lock-acquisition graph has a cycle (lock-order
        inversion). Edges come from lexically nested ``with self.X:``
        blocks and from same-class calls made while a lock is held into
        methods that acquire another lock. Analysis is lexical: code
        that releases a lock before calling out (e.g. the timing wheel
        running callbacks after its ``with`` block closes) creates no
        edge — which is the pattern this repo uses deliberately.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from ..core import Finding, LintContext, ParsedFile, Rule, self_attr

_MUTATORS = {
    "append",
    "add",
    "extend",
    "update",
    "pop",
    "popitem",
    "remove",
    "discard",
    "clear",
    "setdefault",
    "insert",
}

_LOCKISH = ("lock", "cond", "mutex")


def _is_lockish(attr: str) -> bool:
    a = attr.lower()
    return any(t in a for t in _LOCKISH)


def _locked_by_decl(cls: ast.ClassDef) -> Dict[str, Set[str]]:
    """Parse ``@locked_by("_lock", "_a", "_b")`` decorators (stackable)."""
    decls: Dict[str, Set[str]] = {}
    for dec in cls.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        fname = dec.func
        name = (
            fname.id
            if isinstance(fname, ast.Name)
            else fname.attr
            if isinstance(fname, ast.Attribute)
            else ""
        )
        if name != "locked_by" or not dec.args:
            continue
        vals = [
            a.value
            for a in dec.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)
        ]
        if len(vals) >= 2:
            decls.setdefault(vals[0], set()).update(vals[1:])
    return decls


class _MethodScan(ast.NodeVisitor):
    """One method: which guarded fields are written while which of the
    class's locks are (lexically) held."""

    def __init__(self, lock_names: Set[str], held0: Set[str]):
        self.lock_names = lock_names
        self.held: Set[str] = set(held0)
        # (field, lineno, held_at_that_point)
        self.writes: List[Tuple[str, int, Set[str]]] = []
        # lock -> locks acquired while it is held (for MPL302)
        self.nested: List[Tuple[str, str, int]] = []
        # lock -> same-class methods called while it is held
        self.calls_under: List[Tuple[str, str, int]] = []
        # every same-class call: (method, locks_held_at_site, lineno) —
        # MPL301 uses this for the one-level delegation exemption
        self.self_calls: List[Tuple[str, Set[str], int]] = []

    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            attr = self_attr(item.context_expr)
            if attr is None and isinstance(item.context_expr, ast.Call):
                # `with self._lock:` vs `with self._cond:` vs cond.wait()
                attr = self_attr(item.context_expr.func)
            if attr and (attr in self.lock_names or _is_lockish(attr)):
                acquired.append(attr)
        for a in acquired:
            for h in self.held:
                if h != a:
                    self.nested.append((h, a, node.lineno))
        self.held |= set(acquired)
        for stmt in node.body:
            self.visit(stmt)
        self.held -= set(acquired)
        # type comment/withitems need no further walk

    def _record_write(self, field: str, lineno: int) -> None:
        self.writes.append((field, lineno, set(self.held)))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            f = self_attr(t)
            if f:
                self._record_write(f, node.lineno)
            elif isinstance(t, ast.Tuple):
                for el in t.elts:
                    f = self_attr(el)
                    if f:
                        self._record_write(f, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        f = self_attr(node.target)
        if f:
            self._record_write(f, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        f = self_attr(node.target)
        if f and node.value is not None:
            self._record_write(f, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            # self._buffer.append(...) — a write to the container field
            if func.attr in _MUTATORS:
                f = self_attr(func.value)
                if f:
                    self._record_write(f, node.lineno)
            # self.other_method() while holding a lock → call edge
            f = self_attr(func)
            if f:
                self.self_calls.append((f, set(self.held), node.lineno))
                for h in self.held:
                    self.calls_under.append((h, f, node.lineno))
        self.generic_visit(node)

    # nested defs get their own scan via the class walker; don't descend
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        return

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return


class UnguardedLockedField(Rule):
    id = "MPL301"
    summary = "@locked_by fields must only be written under their lock"

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        for cls in ast.walk(pf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            decls = _locked_by_decl(cls)
            if not decls:
                continue
            lock_names = set(decls)
            field_to_lock: Dict[str, str] = {
                f: lock for lock, fields in decls.items() for f in fields
            }
            methods: Dict[str, ast.AST] = {}
            scans: Dict[str, _MethodScan] = {}
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                held0: Set[str] = set()
                holds = pf.holds.get(meth.lineno)
                if holds:
                    held0.add(holds)
                scan = _MethodScan(lock_names, held0)
                for stmt in meth.body:
                    scan.visit(stmt)
                methods[meth.name] = meth
                scans[meth.name] = scan
            # method -> (caller, locks held at each same-class call site)
            call_sites: Dict[str, List[Tuple[str, Set[str]]]] = {}
            for caller, scan in scans.items():
                for callee, held_at, _line in scan.self_calls:
                    call_sites.setdefault(callee, []).append((caller, held_at))
            for name, meth in methods.items():
                if name == "__init__":
                    continue
                for fieldname, lineno, held in scans[name].writes:
                    lock = field_to_lock.get(fieldname)
                    if lock is None or lock in held:
                        continue
                    # one-level delegation: a private helper whose every
                    # same-class call site already holds the lock is
                    # effectively '# mpclint: holds=<lock>' — the lexical
                    # held-set at the call site is what counts, so the
                    # exemption does not chain through a second helper
                    sites = [
                        h
                        for caller, h in call_sites.get(name, ())
                        if caller != name
                    ]
                    if (
                        name.startswith("_")
                        and sites
                        and all(lock in h for h in sites)
                    ):
                        continue
                    yield Finding(
                        rule=self.id,
                        path=pf.rel,
                        line=lineno,
                        symbol=f"{pf.symbol_of(meth)}.{meth.name}".lstrip("."),
                        key=fieldname,
                        message=(
                            f"write to {fieldname!r} outside 'with "
                            f"self.{lock}:' (declared @locked_by); hold the "
                            f"lock or mark the method '# mpclint: "
                            f"holds={lock}'"
                        ),
                    )


class LockOrderInversion(Rule):
    id = "MPL302"
    summary = "lock-acquisition graph must stay acyclic"

    def __init__(self) -> None:
        # "Class.lock" -> {"Class.lock2": (path, line)}
        self._edges: Dict[str, Dict[str, Tuple[str, int]]] = {}

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        for cls in ast.walk(pf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            # per-method: nested with-blocks + calls made under a lock
            acquires: Dict[str, Set[str]] = {}  # method -> locks it takes
            scans: Dict[str, _MethodScan] = {}
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                held0: Set[str] = set()
                holds = pf.holds.get(meth.lineno)
                if holds:
                    held0.add(holds)
                scan = _MethodScan(set(), held0)
                for stmt in meth.body:
                    scan.visit(stmt)
                scans[meth.name] = scan
                taken = {a for (_h, a, _l) in scan.nested}
                taken |= {
                    a
                    for (_f, _l, hs) in scan.writes
                    for a in hs
                }
                # locks this method acquires lexically anywhere
                acquires[meth.name] = _all_acquired(meth)
            qual = lambda lock: f"{cls.name}.{lock}"  # noqa: E731
            for scan in scans.values():
                for held, acq, line in scan.nested:
                    self._edges.setdefault(qual(held), {}).setdefault(
                        qual(acq), (pf.rel, line)
                    )
                for held, callee, line in scan.calls_under:
                    for acq in acquires.get(callee, ()):
                        if acq != held:
                            self._edges.setdefault(qual(held), {}).setdefault(
                                qual(acq), (pf.rel, line)
                            )
        return iter(())

    def finalize(self, ctx: LintContext) -> Iterator[Finding]:
        # DFS cycle detection over the accumulated graph
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[str, int] = {}
        stack: List[str] = []
        cycles: List[List[str]] = []

        def dfs(n: str) -> None:
            color[n] = GRAY
            stack.append(n)
            for m in self._edges.get(n, {}):
                c = color.get(m, WHITE)
                if c == WHITE:
                    dfs(m)
                elif c == GRAY:
                    cycles.append(stack[stack.index(m) :] + [m])
            stack.pop()
            color[n] = BLACK

        for n in sorted(self._edges):
            if color.get(n, WHITE) == WHITE:
                dfs(n)
        seen: Set[Tuple[str, ...]] = set()
        for cyc in cycles:
            canon = tuple(sorted(set(cyc)))
            if canon in seen:
                continue
            seen.add(canon)
            a, b = cyc[0], cyc[1 % len(cyc)]
            path, line = self._edges[a][b]
            yield Finding(
                rule=self.id,
                path=path,
                line=line,
                symbol="",
                key="->".join(cyc),
                message=(
                    f"lock-order inversion: {' -> '.join(cyc)} — impose a "
                    f"global order or release before calling out"
                ),
            )


def _all_acquired(meth: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(meth):
        if isinstance(node, ast.With):
            for item in node.items:
                attr = self_attr(item.context_expr)
                if attr and _is_lockish(attr):
                    out.add(attr)
    return out
