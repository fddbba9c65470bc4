"""What the benchmark may load: no module under benchmark/ imports jax,
jaxlib, flax or ray_tpu (the JAX package), top-level names compared whole;
the reference imports nothing of the port either; nothing reads the repo's
older drivers or their results."""

import ast
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ray_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imported(path: Path, tree=None):
    """Top-level names of the modules `path` (or its parsed `tree`) imports."""
    tree = tree if tree is not None else ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    assert not set(imported(path)) & FORBIDDEN


def test_the_names_are_compared_whole():
    assert "ray_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_only_torch():
    assert set(imported(BENCH / "reference.py")) <= {"__future__", "math", "typing", "torch"}


OLDER = re.compile(r"(^|/)(bench\.py|bench_torch\.py|chip_smoke\.py|BENCH_[^/]*\.json)$")


@pytest.mark.parametrize("path", [p for p in SOURCES if p.name != Path(__file__).name],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_older_drivers(path):
    """No string in the code names one of those files (docstrings may cite
    where a formula was copied from)."""
    tree = ast.parse(path.read_text())
    names = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
             and isinstance(n.value, str) and OLDER.search(n.value)]
    imports = set(imported(path)) & {"bench", "bench_torch", "chip_smoke"}
    assert not names and not imports


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    import sys
    import types

    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("path", sorted((BENCH / "families").glob("[!_]*.py")),
                         ids=lambda p: p.name)
def test_a_family_s_reference_imports_nothing_of_the_port(path):
    """Only `program_config` may import the port: a family's reference
    forward, leaves and counts are plain torch and the benchmark's own."""
    tree = ast.parse(path.read_text())
    outside = [n for n in tree.body
               if not (isinstance(n, ast.FunctionDef) and n.name == "program_config")]
    found = set(imported(path, ast.Module(body=outside, type_ignores=[])))
    assert found <= {"__future__", "math", "typing", "torch", "benchmark"}, found
