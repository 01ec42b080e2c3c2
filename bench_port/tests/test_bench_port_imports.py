"""Nothing the benchmark runs imports JAX, Flax or the JAX package (compared
by whole top-level module names: ``cfgpp_tpu_torch`` begins with
``cfgpp_tpu``), and the reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from bench_port import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "cfgpp_tpu"}
SOURCES = sorted(p for p in manifest.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(manifest.HERE))
                              for p in SOURCES])
def test_no_forbidden_import(path):
    names = set(top_level_imports(path))
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if "reference" in path.relative_to(manifest.HERE).parts:
        assert "cfgpp_tpu_torch" not in names


def test_a_run_loads_no_jax():
    """A whole run in a fresh interpreter (a tiny cell on the CPU) leaves no
    forbidden module in ``sys.modules``."""
    code = (
        "import sys\n"
        "from bench_port.tests.tiny import tiny_cell\n"
        "from bench_port.run import run_cell, loaded_forbidden, "
        "set_environment\n"
        "set_environment()\n"
        "cell = tiny_cell('sd15_t2i_b1', nfe=2, warmup_nfe=2)\n"
        "run_cell(cell, 5, 0.1, False, 'cpu')\n"
        "print(loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=manifest.REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
