"""Project-wide symbol table for mpcflow (the port's copy of the JAX
package's ``analysis/flow/symbols.py``).

Turns the flat ParsedFile list into what interprocedural analysis needs:

- every function/method/nested-def gets a stable **fid**
  (``rel::dotted.qualname``, e.g.
  ``mpcium_tpu_torch/protocol/ecdsa/mta_ot.py::OTMtALeg.run_multi``);
- per-module import resolution (absolute and relative, alias-aware), so
  ``from ...core import bignum as bn`` lets a call ``bn.carry(x)``
  resolve to ``mpcium_tpu_torch/core/bignum.py::carry``;
- per-class method tables including **project base classes** and
  class-body first-class assignments
  (``_parse_bytes = BatchBlockMixin._parse_block``), so mixin dispatch
  resolves.

Resolution is best-effort and project-scoped: anything outside
``mpcium_tpu_torch`` (stdlib, torch, numpy) resolves to ``None`` and the
engine treats the call conservatively.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core import ParsedFile

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)

PKG = "mpcium_tpu_torch"


def module_of(rel: str) -> str:
    """'mpcium_tpu_torch/core/bignum.py' → 'mpcium_tpu_torch.core.bignum'."""
    mod = rel[:-3] if rel.endswith(".py") else rel
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


class FuncInfo:
    """One function/method definition."""

    __slots__ = (
        "fid", "pf", "node", "qualname", "cls", "params",
        "secret_params", "secret_return", "parent_fid",
    )

    def __init__(
        self,
        pf: ParsedFile,
        node,
        qualname: str,
        cls: Optional[str],
        parent_fid: Optional[str],
    ):
        self.pf = pf
        self.node = node
        self.qualname = qualname
        self.fid = f"{pf.rel}::{qualname}"
        self.cls = cls  # "rel::ClassQualname" when a method
        self.parent_fid = parent_fid  # enclosing function (closures)
        a = node.args
        self.params: List[str] = [
            p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
        ]
        # Secret[...] markers (utils/annotations.py)
        self.secret_params: Set[str] = {
            p.arg
            for p in a.posonlyargs + a.args + a.kwonlyargs
            if _is_secret_annotation(p.annotation)
        }
        self.secret_return = _is_secret_annotation(node.returns)

    @property
    def display(self) -> str:
        return f"{self.pf.rel}::{self.qualname}"


def _is_secret_annotation(ann) -> bool:
    """True for ``Secret[...]`` / ``annotations.Secret[...]``, in direct
    or string ('Secret[bytes]') form."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Subscript):
        base = ann.value
        name = (
            base.id
            if isinstance(base, ast.Name)
            else base.attr
            if isinstance(base, ast.Attribute)
            else ""
        )
        return name == "Secret"
    return False


def _dotted(node) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class ClassInfo:
    __slots__ = ("cid", "pf", "node", "qualname", "methods", "bases")

    def __init__(self, pf: ParsedFile, node: ast.ClassDef, qualname: str):
        self.pf = pf
        self.node = node
        self.qualname = qualname
        self.cid = f"{pf.rel}::{qualname}"
        self.methods: Dict[str, str] = {}  # name -> fid
        self.bases: List[str] = []  # resolved project cids


class ProjectIndex:
    """Symbol table over one ParsedFile set."""

    def __init__(self, files: Sequence[ParsedFile]):
        self.files = list(files)
        self.functions: Dict[str, FuncInfo] = {}  # fid -> info
        self.classes: Dict[str, ClassInfo] = {}  # cid -> info
        # module ('mpcium_tpu_torch.core.bignum') -> rel path
        self.modules: Dict[str, str] = {}
        # (rel, local alias) -> ('module', modname) | ('symbol', fid/cid)
        self.imports: Dict[Tuple[str, str], Tuple[str, str]] = {}
        # (rel, top-level name) -> fid/cid defined in that module
        self.module_defs: Dict[Tuple[str, str], str] = {}
        # method name -> cids defining it (unique-name fallback)
        self.method_homes: Dict[str, List[str]] = {}

        for pf in self.files:
            self.modules[module_of(pf.rel)] = pf.rel
        for pf in self.files:
            self._index_defs(pf)
        for pf in self.files:
            self._index_imports(pf)
        self._link_classes()

    # -- definitions --------------------------------------------------------

    def _index_defs(self, pf: ParsedFile) -> None:
        def walk(node, stack: List[str], cls: Optional[str], parent_fid):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    qn = ".".join(stack + [child.name])
                    ci = ClassInfo(pf, child, qn)
                    self.classes[ci.cid] = ci
                    if not stack:
                        self.module_defs[(pf.rel, child.name)] = ci.cid
                    walk(child, stack + [child.name], ci.cid, parent_fid)
                elif isinstance(child, FuncNode):
                    qn = ".".join(stack + [child.name])
                    fi = FuncInfo(pf, child, qn, cls, parent_fid)
                    self.functions[fi.fid] = fi
                    if not stack:
                        self.module_defs[(pf.rel, child.name)] = fi.fid
                    if cls is not None and self.classes[cls].node is node:
                        self.classes[cls].methods[child.name] = fi.fid
                    # nested defs: enclosing class no longer applies
                    walk(child, stack + [child.name], None, fi.fid)
                else:
                    walk(child, stack, cls, parent_fid)

        walk(pf.tree, [], None, None)

    # -- imports ------------------------------------------------------------

    def _resolve_module(self, modname: str) -> Optional[str]:
        if modname in self.modules:
            return modname
        return None

    def _index_imports(self, pf: ParsedFile) -> None:
        here = module_of(pf.rel)
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    target = self._resolve_module(alias.name)
                    if target:
                        local = alias.asname or alias.name.split(".")[0]
                        # `import a.b.c` binds `a`; only map exact-alias uses
                        if alias.asname or "." not in alias.name:
                            self.imports[(pf.rel, local)] = ("module", target)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = here.split(".")
                    # `from . import x` in pkg/mod.py: level 1 = pkg
                    parts = parts[: len(parts) - node.level]
                    base = ".".join(parts + ([base] if base else []))
                for alias in node.names:
                    local = alias.asname or alias.name
                    submod = f"{base}.{alias.name}" if base else alias.name
                    if self._resolve_module(submod):
                        self.imports[(pf.rel, local)] = ("module", submod)
                        continue
                    src_rel = self.modules.get(base)
                    if src_rel is None:
                        continue
                    target = self.module_defs.get((src_rel, alias.name))
                    if target:
                        self.imports[(pf.rel, local)] = ("symbol", target)

    # -- class linking ------------------------------------------------------

    def _link_classes(self) -> None:
        for ci in self.classes.values():
            for base in ci.node.bases:
                resolved = self.resolve_name_target(ci.pf.rel, _dotted(base))
                if resolved in self.classes:
                    ci.bases.append(resolved)
            # class-body first-class assignments:
            #   _parse_bytes = BatchBlockMixin._parse_block
            for stmt in ci.node.body:
                if not (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                ):
                    continue
                fid = self.resolve_name_target(
                    ci.pf.rel, _dotted(stmt.value)
                )
                if fid in self.functions:
                    ci.methods[stmt.targets[0].id] = fid
        for ci in self.classes.values():
            for name, fid in ci.methods.items():
                self.method_homes.setdefault(name, []).append(ci.cid)

    # -- lookups ------------------------------------------------------------

    def resolve_name_target(self, rel: str, dotted: str) -> Optional[str]:
        """Resolve a possibly-dotted name used in ``rel`` to a project
        fid/cid: local module def, imported symbol, or attribute chain
        through imported modules / project classes."""
        if not dotted:
            return None
        parts = dotted.split(".")
        head, rest = parts[0], parts[1:]
        target = self.module_defs.get((rel, head))
        kind = None
        if target is None:
            imp = self.imports.get((rel, head))
            if imp is None:
                return None
            kind, target = imp
        if not rest:
            return target
        if kind == "module" or target in self.modules:
            # walk module attributes: mod.sub.fn
            modname = target
            while rest:
                nxt = f"{modname}.{rest[0]}"
                if nxt in self.modules:
                    modname, rest = nxt, rest[1:]
                    continue
                src_rel = self.modules.get(modname)
                if src_rel is None:
                    return None
                return self.module_defs.get((src_rel, rest[0])) if len(
                    rest
                ) == 1 else None
            return None
        if target in self.classes and len(rest) == 1:
            return self.lookup_method(target, rest[0])
        return None

    def lookup_method(self, cid: str, name: str) -> Optional[str]:
        """Method resolution through project bases (MRO-ish, DFS)."""
        seen: Set[str] = set()
        stack = [cid]
        while stack:
            c = stack.pop(0)
            if c in seen or c not in self.classes:
                continue
            seen.add(c)
            ci = self.classes[c]
            if name in ci.methods:
                return ci.methods[name]
            stack.extend(ci.bases)
        return None

    def enclosing_class(self, fi: FuncInfo) -> Optional[ClassInfo]:
        return self.classes.get(fi.cls) if fi.cls else None
