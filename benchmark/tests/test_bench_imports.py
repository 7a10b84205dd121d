"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared by their
top-level name, whole: ``gppe_tpu_torch`` is not ``gppe_tpu``."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.reference import check

from .cells import CELLS, tiny_cell

BENCH = Path(run.__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gppe_tpu"}


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


def test_no_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        assert not _imported(path) & FORBIDDEN, path


def test_reference_sources_import_nothing_of_the_program():
    for path in list((BENCH / "reference").glob("*.py")) + [
            BENCH / "data.py", BENCH / "spec.py"]:
        assert "gppe_tpu_torch" not in _imported(path), path


def _python(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_reference_loads_nothing_of_the_program():
    out = _python(
        "import sys\n"
        "import benchmark.reference.check, benchmark.reference.krylov\n"
        "import benchmark.reference.matern, benchmark.reference.tapered\n"
        "import benchmark.work.matern, benchmark.work.tapered\n"
        "bad = {m.partition('.')[0] for m in sys.modules} & "
        "{'gppe_tpu_torch', 'jax', 'jaxlib', 'flax', 'gppe_tpu'}\n"
        "print(sorted(bad))\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    """A tiny job of every cell, then the run's own look at sys.modules."""
    out = _python(
        "import torch\n"
        "from benchmark import run\n"
        "from benchmark.tests.cells import CELLS, tiny_cell\n"
        "torch.set_num_threads(2)\n"
        "for name in CELLS[:3]:\n"
        "    result, _ = run.measure(tiny_cell(name), 5, 0.1, False,\n"
        "                            torch.device('cpu'))\n"
        "    assert result['correct'], name\n"
        "print(run.forbidden_modules())\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", ["jax", "gppe_tpu"])
def test_a_reference_that_loads_jax_gives_no_result(monkeypatch, capsys,
                                                     name):
    """A module that the reference loads as it reads the checked job, after
    the window: the run ends with no result."""
    readings = check.readings

    def loading(*args, **kwargs):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        return readings(*args, **kwargs)

    monkeypatch.setattr(check, "readings", loading)
    with pytest.raises(SystemExit, match=name):
        run.measure(tiny_cell(CELLS[0]), 3, 0.1, False, torch.device("cpu"))
    assert capsys.readouterr().out == ""
