"""mpclint core: findings, parsed files, suppressions, the rule runner
(the port's copy of the JAX package's ``analysis/core.py``, rooted at
``mpcium_tpu_torch``).

The model is deliberately small:

- a :class:`Finding` is one violation with a *stable fingerprint*
  (rule + path + enclosing symbol + a rule-chosen detail key — line
  numbers are display-only, so baselines survive unrelated edits);
- a :class:`Rule` visits one :class:`ParsedFile` at a time and may keep
  cross-file state until :meth:`Rule.finalize` (the lock-graph rule
  needs the whole package before it can look for cycles);
- suppression is per-line (``# mpclint: disable=MPL101 — reason``) or
  per-file (``# mpclint: disable-file=MPL101`` in the header), parsed
  from raw source so rules never have to think about it.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

_DISABLE_RE = re.compile(r"#\s*mpclint:\s*disable=([A-Za-z0-9_,\s]+?)(?:\s*[—-]|$)")
_DISABLE_FILE_RE = re.compile(
    r"#\s*mpclint:\s*disable-file=([A-Za-z0-9_,\s]+?)(?:\s*[—-]|$)"
)
_SECRET_ANNOT_RE = re.compile(r"#\s*mpclint:\s*secret\b")
_HOLDS_RE = re.compile(r"#\s*mpclint:\s*holds=([A-Za-z0-9_]+)")
# mpcflow (analysis/flow/) annotations, indexed here so both tools share
# one parse of every file:
#   x = drain()       # mpcflow: host-ok — wire egress: payload leaves device
#   pub = digest(sk)  # mpcflow: declassified — commitment, not the secret
_HOST_OK_RE = re.compile(r"#\s*mpcflow:\s*host-ok(?:\s*[—-]\s*(.*))?$")
_DECLASSIFY_RE = re.compile(r"#\s*mpcflow:\s*declassified\b")


@dataclass(frozen=True)
class Finding:
    """One violation. ``key`` is the rule-chosen stable detail (usually
    the offending identifier), so the fingerprint survives line drift."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    symbol: str  # dotted enclosing scope, "" at module level
    key: str
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}:{self.key}"

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.rule}{sym} {self.message}"


class ParsedFile:
    """One source file: AST + per-line suppression/annotation indexes."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        # line -> set of rule ids disabled on that line ("*" = all)
        self.disabled: Dict[int, Set[str]] = {}
        self.disabled_file: Set[str] = set()
        # lines carrying a `# mpclint: secret` annotation
        self.secret_lines: Set[int] = set()
        # lines whose `def` carries `# mpclint: holds=<lock>`
        self.holds: Dict[int, str] = {}
        # mpcflow: line -> reason for an intentional host transfer, and
        # lines whose assignments declassify secret taint
        self.host_ok: Dict[int, str] = {}
        self.declassified: Set[int] = set()
        for i, text in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(text)
            if m:
                self.disabled[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
            m = _DISABLE_FILE_RE.search(text)
            if m and i <= 15:
                self.disabled_file |= {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
            if _SECRET_ANNOT_RE.search(text):
                self.secret_lines.add(i)
            m = _HOLDS_RE.search(text)
            if m:
                self.holds[i] = m.group(1)
            m = _HOST_OK_RE.search(text)
            if m:
                self.host_ok[i] = (m.group(1) or "").strip()
            if _DECLASSIFY_RE.search(text):
                self.declassified.add(i)
        # extra secret names declared via `# mpclint: secret` annotations:
        # every assignment/arg defined on an annotated line
        self.extra_secrets: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and (
                node.lineno in self.secret_lines
            ):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            self.extra_secrets.add(n.id)
                        elif isinstance(n, ast.Attribute):
                            self.extra_secrets.add(n.attr)
            elif isinstance(node, ast.arg) and node.lineno in self.secret_lines:
                self.extra_secrets.add(node.arg)
        # node -> dotted enclosing symbol
        self._symbols: Dict[ast.AST, str] = {}
        self._index_symbols(self.tree, [])

    def _index_symbols(self, node: ast.AST, stack: List[str]) -> None:
        name = getattr(node, "name", None)
        scoped = isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        )
        if scoped:
            stack = stack + [name]
        for child in ast.iter_child_nodes(node):
            self._symbols[child] = ".".join(stack)
            self._index_symbols(child, stack)

    def symbol_of(self, node: ast.AST) -> str:
        return self._symbols.get(node, "")

    def is_suppressed(self, rule: str, line: int) -> bool:
        if rule in self.disabled_file or "*" in self.disabled_file:
            return True
        # the flagged line, or a continuation: also honor the line above
        # (comment-on-its-own-line style for long statements)
        for ln in (line, line - 1):
            tags = self.disabled.get(ln)
            if tags and (rule in tags or "*" in tags or "all" in tags):
                return True
        return False


class LintContext:
    """Shared state across files: the file set plus per-rule scratch."""

    def __init__(self, files: Sequence[ParsedFile]):
        self.files = list(files)
        self.by_rel: Dict[str, ParsedFile] = {f.rel: f for f in files}
        self.scratch: Dict[str, object] = {}


class Rule:
    """Base rule. Subclasses set ``id``/``summary`` and implement
    :meth:`check`; rules needing the whole package implement
    :meth:`finalize` too (called once, after every file)."""

    id: str = "MPL000"
    summary: str = ""

    def applies(self, rel: str) -> bool:
        return True

    def check(self, pf: ParsedFile, ctx: LintContext) -> Iterator[Finding]:
        return iter(())

    def finalize(self, ctx: LintContext) -> Iterator[Finding]:
        return iter(())


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)
    files_scanned: int = 0
    parse_errors: List[str] = field(default_factory=list)


def iter_py_files(paths: Sequence[Path], root: Path) -> Iterator[Tuple[Path, str]]:
    seen: Set[Path] = set()
    for p in paths:
        p = p.resolve()
        candidates: Iterable[Path]
        if p.is_dir():
            candidates = sorted(p.rglob("*.py"))
        else:
            candidates = [p]
        for c in candidates:
            if c in seen or c.suffix != ".py":
                continue
            seen.add(c)
            try:
                rel = c.resolve().relative_to(root.resolve()).as_posix()
            except ValueError:
                rel = c.name
            yield c, rel


def parse_project(
    paths: Sequence[Path],
    root: Optional[Path] = None,
) -> Tuple[List[ParsedFile], List[str]]:
    """Parse every ``.py`` under ``paths`` once → (files, parse_errors).
    This is the shared AST cache: scripts/torch_check_all.py parses here and
    hands the same ParsedFile list to mpclint AND mpcflow."""
    root = root or Path.cwd()
    files: List[ParsedFile] = []
    errors: List[str] = []
    for path, rel in iter_py_files(paths, root):
        try:
            files.append(ParsedFile(path, rel, path.read_text()))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{rel}: {e}")
    return files, errors


def lint_parsed(
    files: Sequence[ParsedFile],
    rules: Sequence[Rule],
    parse_errors: Sequence[str] = (),
) -> LintResult:
    """Run ``rules`` over already-parsed files (see parse_project).
    Suppressed findings are filtered here, centrally."""
    result = LintResult()
    result.parse_errors = list(parse_errors)
    result.files_scanned = len(files)
    ctx = LintContext(files)
    for pf in files:
        for rule in rules:
            if not rule.applies(pf.rel):
                continue
            for f in rule.check(pf, ctx):
                if not pf.is_suppressed(f.rule, f.line):
                    result.findings.append(f)
    for rule in rules:
        for f in rule.finalize(ctx):
            pf = ctx.by_rel.get(f.path)
            if pf is None or not pf.is_suppressed(f.rule, f.line):
                result.findings.append(f)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return result


def lint_paths(
    paths: Sequence[Path],
    rules: Sequence[Rule],
    root: Optional[Path] = None,
) -> LintResult:
    """Parse + lint in one call (the single-tool entry point)."""
    files, errors = parse_project(paths, root=root)
    return lint_parsed(files, rules, parse_errors=errors)


def run_lint(
    paths: Optional[Sequence[Path]] = None,
    root: Optional[Path] = None,
) -> LintResult:
    """Full-rule-set sweep — the entry point the test gate and CLI share.
    Defaults to the ``mpcium_tpu_torch`` package next to this file's repo
    root."""
    from .rules import all_rules

    root = root or Path(__file__).resolve().parents[2]
    paths = list(paths) if paths else [root / "mpcium_tpu_torch"]
    return lint_paths(paths, all_rules(), root=root)


# -- shared AST helpers (used by several rule modules) -----------------------


def dotted_name(node: ast.AST) -> str:
    """'a.b.c' for Name/Attribute chains, '' for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def self_attr(node: ast.AST) -> Optional[str]:
    """'x' for ``self.x``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None
