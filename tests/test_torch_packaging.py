"""The port's package data ships every source it builds at first use.

``ops/mulmod.py`` builds ``ops/csrc/mulmod.cu`` with nvcc and
``native/__init__.py`` builds ``native/batch_hash.cpp`` with g++, each
from the file next to the installed module (its ``SRC``). A source that
``[tool.setuptools.package-data]`` does not match is missing from a
wheel, and the installed package then raises at the first call that
builds it. The sources are found by reading the modules: every
module-level ``SRC`` assignment in ``mpcium_tpu_torch/``."""
from __future__ import annotations

import ast
import importlib
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mpcium_tpu_torch"


def _package_data():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]["mpcium_tpu_torch"]


def _build_sources():
    """module name -> its SRC, for every module that assigns SRC at top level."""
    out = {}
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        if any(isinstance(node, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "SRC" for t in node.targets)
               for node in tree.body):
            parts = path.relative_to(ROOT).with_suffix("").parts
            name = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
            out[name] = Path(importlib.import_module(name).SRC)
    return out


def test_every_source_built_at_first_use_is_package_data():
    sources = _build_sources()
    assert {"mpcium_tpu_torch.ops.mulmod", "mpcium_tpu_torch.native"} <= set(sources)
    assert {p.relative_to(PKG).as_posix() for p in sources.values()} >= {
        "ops/csrc/mulmod.cu", "native/batch_hash.cpp"}
    shipped = {p for pattern in _package_data() for p in PKG.glob(pattern)}
    missing = {name: str(src.relative_to(PKG)) for name, src in sources.items()
               if src not in shipped}
    assert not missing, f"built at first use but not package data: {missing}"


def test_every_compiled_source_beside_them_is_package_data():
    """Sources a build could include from its own directory ship too."""
    dirs = {src.parent for src in _build_sources().values()}
    shipped = {p for pattern in _package_data() for p in PKG.glob(pattern)}
    beside = {p for d in dirs for p in d.iterdir()
              if p.suffix in (".cu", ".cuh", ".cpp", ".cc", ".h", ".hpp")}
    assert beside and beside <= shipped, sorted(str(p) for p in beside - shipped)
