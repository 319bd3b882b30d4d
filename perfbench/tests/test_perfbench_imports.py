"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (``modflow6_torch`` begins with the JAX package's name)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_names_compared_whole():
    assert "modflow6_torch".split(".")[0] not in run.BANNED
    assert "modflow6_tpu" in run.BANNED


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_sources_import_no_jax(path):
    assert not _top_level_imports(path) & set(run.BANNED)


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_sources_import_nothing_of_the_program(path):
    assert "modflow6_torch" not in _top_level_imports(path)


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import perfbench.reference.flow, "
                          "perfbench.reference.krylov")
    assert "modflow6_torch" not in mods
    assert not mods & set(run.BANNED)


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "from perfbench.tests.helpers import run_small\n"
        "run_small('npf-jacobi-replay')")
    assert "modflow6_torch" in mods
    assert not mods & set(run.BANNED)
