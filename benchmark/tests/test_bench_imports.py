"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared whole
(the program's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

from benchmark import harness

FILES = sorted(harness.HERE.rglob("*.py"))


def _imported(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not _imported(path) & {"jax", "jaxlib", "flax", "debigulator_tpu"}


#: The yardstick: the generator and its parts, the reference, the peaks.
YARDSTICK = ["reference.py", "inputs.py", "peaks.py", "parts.py"] + sorted(
    str(p.relative_to(harness.HERE)) for kind in ("makers", "texts", "pixels")
    for p in (harness.HERE / kind).glob("*.py"))


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    path = harness.HERE / name
    assert "debigulator_tpu_torch" not in _imported(path)
    # ...nor does anything it loads.
    code = ("import sys, runpy; "
            f"runpy.run_path({str(path)!r}, run_name='yardstick'); "
            "import benchmark.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, check=True).stdout
    assert "'debigulator_tpu_torch'" not in out and "'jax'" not in out


def test_a_run_loads_no_jax():
    """The modules a run loads, the program's included, pull in no JAX."""
    code = ("import sys, benchmark.run, benchmark.harness, benchmark.control; "
            "import debigulator_tpu_torch.parallel.merged, "
            "debigulator_tpu_torch.models.pipeline; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, check=True).stdout
    for bad in ("jax", "jaxlib", "flax", "debigulator_tpu"):
        assert f"'{bad}'" not in out
