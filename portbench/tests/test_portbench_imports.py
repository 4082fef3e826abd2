"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole:
the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast

import pytest

from portbench.tests.tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_names(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_imports(path):
    names = top_names(path)
    assert not names & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names


def test_check_sees_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro.match\nfrom jax import numpy\n"
                 "import repro_torch\n")
    assert top_names(f) == {"repro", "jax", "repro_torch"}
