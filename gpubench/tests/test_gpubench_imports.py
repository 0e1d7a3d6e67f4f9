"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""

from __future__ import annotations

import ast
import sys
import types

import pytest

from gpubench import run
from gpubench.core import cell

PROGRAM = "tinynerf_tpu_torch"


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("loaded, found", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]),
    ("flax.linen", ["flax"]), ("tinynerf_tpu.kernels", ["tinynerf_tpu"]),
    ("tinynerf_tpu_torch.kernels", []), ("jaxtyping", []), ("flaxen", []),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, loaded, found):
    for mod in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    assert run.forbidden_modules() == found


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in cell.BENCH.rglob("*.py"):
        assert not top_level_imports(path) & set(run.FORBIDDEN), path


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    yardstick = list((cell.BENCH / "reference").glob("*.py")) + [
        cell.BENCH / "core" / n for n in ("scenes.py", "work.py", "check.py", "readers.py")]
    for path in yardstick:
        assert PROGRAM not in top_level_imports(path), path


def test_nothing_reads_the_jax_benchmarks_folder():
    folder = "bench" + "marks/"
    for path in cell.BENCH.rglob("*.py"):
        assert folder not in path.read_text(), path
