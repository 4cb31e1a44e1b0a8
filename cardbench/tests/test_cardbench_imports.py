"""The import guard: nothing under cardbench/ imports JAX, Flax or the JAX
package, and the reference imports nothing of the program; names compare
by their whole top-level part (the port's name begins with the JAX
package's)."""

import ast

import pytest

from cardbench import harness
from cardbench.tests.tiny import SEED, TINY

BANNED = {"jax", "jaxlib", "flax", "litcoder_core_tpu"}
MODULES = sorted(p for p in harness.BENCH_DIR.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(harness.BENCH_DIR))
                              for p in MODULES])
def test_module_imports(path):
    names = top_level_imports(path)
    assert not names & BANNED
    if "reference" in path.relative_to(harness.BENCH_DIR).parts:
        assert "litcoder_core_torch" not in names
        assert names <= {"math", "typing", "numpy", "torch", "scipy",
                         "cardbench"}


def test_names_compare_whole():
    assert harness.BANNED_MODULES == ("jax", "jaxlib", "flax",
                                      "litcoder_core_tpu")
    assert "litcoder_core_torch".split(".")[0] not in harness.BANNED_MODULES


def test_a_run_loads_no_banned_module():
    harness.run_cell("lebel.train_lm", SEED, 0.1, False, device="cpu",
                     overrides=TINY["lebel.train_lm"], log=lambda m: None)
    assert harness.banned_modules() == []
