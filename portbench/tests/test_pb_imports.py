"""Nothing in portbench imports JAX or the JAX package (top-level names
compared whole: fscl_tpu_torch begins with fscl_tpu), and the plain
reference under ref/ imports nothing of the program."""

from __future__ import annotations

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "fscl_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HERE / "ref").rglob("*.py")),
    ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert "fscl_tpu_torch" not in top_level_imports(path)


def test_the_whole_name_is_compared():
    from portbench.harness import forbidden_modules
    import sys

    assert "fscl_tpu_torch" not in forbidden_modules()
    sys.modules["fscl_tpu"] = sys  # a stand-in module
    try:
        assert forbidden_modules() == ["fscl_tpu"]
    finally:
        del sys.modules["fscl_tpu"]
