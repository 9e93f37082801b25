"""Call graph over the project symbol table.

Resolves, per function body, every call site to a project fid when it
can:

- plain calls — ``carry(x)`` / ``bn.carry(x)`` via the module import map;
- method calls — ``self._step(x)`` through the enclosing class (and its
  project bases), ``Cls.method(obj, x)`` via the class table;
- constructor calls — ``OTMtALeg(...)`` → ``OTMtALeg.__init__``;
- closures — a nested ``def`` invoked by name in its enclosing scope;
- first-class passing — **local aliasing** (``fn = self._hash_rows``
  then ``fn(x)``) and **unique-method fallback**: ``obj.run_multi(...)``
  on an unknown receiver resolves iff exactly one project class defines
  ``run_multi`` (true for the protocol/engine names we care about; a
  name defined by many classes stays unresolved rather than guessing).

Edges carry the call line so taint findings can print real chains.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .symbols import FuncInfo, FuncNode, ProjectIndex, _dotted

# names too generic for the unique-method fallback even when unique
_FALLBACK_BLOCKLIST = {
    "get", "put", "close", "run", "start", "stop", "append", "send",
    "recv", "read", "write", "update", "items", "keys", "values",
}


def _nested_ids(fi: FuncInfo) -> Set[int]:
    """ids of the nodes that lexically sit inside a def nested in ``fi``
    — their edges belong to the nested function's own fid."""
    out: Set[int] = set()
    for node in ast.walk(fi.node):
        if isinstance(node, FuncNode) and node is not fi.node:
            out.update(id(sub) for sub in ast.walk(node))
    return out


class CallSite:
    __slots__ = ("callee", "line", "node")

    def __init__(self, callee: str, line: int, node: ast.Call):
        self.callee = callee  # fid
        self.line = line
        self.node = node


class CallGraph:
    def __init__(self, index: ProjectIndex):
        self.index = index
        self.calls: Dict[str, List[CallSite]] = {}  # caller fid -> sites
        self.callers: Dict[str, Set[str]] = {}  # callee fid -> caller fids
        for fid, fi in index.functions.items():
            sites = list(self._resolve_body(fi))
            self.calls[fid] = sites
            for s in sites:
                self.callers.setdefault(s.callee, set()).add(fid)

    # ------------------------------------------------------------------

    def _resolve_body(self, fi: FuncInfo):
        idx = self.index
        rel = fi.pf.rel
        # one pass for local function-valued aliases:
        #   fn = self._hash_rows   /   step = _kernel
        aliases: Dict[str, str] = {}
        for node in ast.walk(fi.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, (ast.Name, ast.Attribute))
            ):
                tgt = self.resolve_callee(fi, node.value)
                if tgt:
                    aliases[node.targets[0].id] = tgt
        nested = _nested_ids(fi)
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call) or id(node) in nested:
                # nested def bodies get their own FuncInfo; skip their calls
                continue
            callee = self.resolve_callee(fi, node.func)
            if callee is None and isinstance(node.func, ast.Name):
                callee = aliases.get(node.func.id)
            if callee is not None and callee in idx.functions:
                yield CallSite(callee, node.lineno, node)
            elif callee is not None and callee in idx.classes:
                init = idx.lookup_method(callee, "__init__")
                if init:
                    yield CallSite(init, node.lineno, node)

    # ------------------------------------------------------------------

    def resolve_callee(self, fi: FuncInfo, func) -> Optional[str]:
        """fid/cid for a call-target expression inside ``fi``, or None."""
        idx = self.index
        rel = fi.pf.rel
        # self.method(...) — enclosing class dispatch (project bases incl.)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id in ("self", "cls")
            and fi.cls
        ):
            m = idx.lookup_method(fi.cls, func.attr)
            if m:
                return m
        dotted = _dotted(func)
        if dotted:
            tgt = idx.resolve_name_target(rel, dotted)
            if tgt:
                return tgt
            # closure: nested def in an enclosing function of this one
            if "." not in dotted:
                scope: Optional[str] = fi.fid
                while scope:
                    cand = f"{scope.rsplit('::', 1)[0]}::" + (
                        f"{scope.rsplit('::', 1)[1]}.{dotted}"
                    )
                    if cand in idx.functions:
                        return cand
                    scope = idx.functions[scope].parent_fid if (
                        scope in idx.functions
                    ) else None
        # unique-method fallback for obj.m(...) with unknown receiver
        if isinstance(func, ast.Attribute):
            name = func.attr
            homes = idx.method_homes.get(name, [])
            if len(homes) == 1 and name not in _FALLBACK_BLOCKLIST:
                return idx.lookup_method(homes[0], name)
        return None

    # ------------------------------------------------------------------

    def reachable_from(self, roots: Set[str]) -> Set[str]:
        """Transitive closure of call edges from ``roots`` (fids)."""
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.index.functions]
        while stack:
            fid = stack.pop()
            if fid in seen:
                continue
            seen.add(fid)
            for s in self.calls.get(fid, ()):
                if s.callee not in seen:
                    stack.append(s.callee)
        return seen
