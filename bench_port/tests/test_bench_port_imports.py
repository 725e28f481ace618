"""What the benchmark loads: never JAX or the JAX package (compared by
whole top-level names: ``distlr_tpu_torch`` is not ``distlr_tpu``), and
a reference that takes nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from bench_port.run import FORBIDDEN, forbidden_modules
from bench_port.tests.conftest import ROOT


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_top_level_names_compared_whole():
    names = ["distlr_tpu_torch", "distlr_tpu_torch.ops", "jax_like", "flaxen", "numpy"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["distlr_tpu.ops", "jaxlib", "jax.numpy", "flax"]) == [
        "distlr_tpu.ops", "flax", "jax.numpy", "jaxlib"]


def test_no_file_of_the_benchmark_imports_jax():
    for path in sorted((ROOT / "bench_port").rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), path


def test_reference_takes_nothing_of_the_program():
    for path in sorted((ROOT / "bench_port" / "reference").rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "numpy", "torch"}, (path, tops)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole CPU run in a fresh process; then ``sys.modules``."""
    code = (
        "import sys\n"
        "from bench_port import run\n"
        "from bench_port.tests.conftest import tiny_cell, KEPT\n"
        "for w in KEPT:\n"
        "    r = run.run_cell(tiny_cell(w), seed=3, seconds=0.01, traced=True, device='cpu')\n"
        "    assert r['correct'], r['checks']\n"
        "print('FOUND', run.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "FOUND []", out.stdout[-2000:]
