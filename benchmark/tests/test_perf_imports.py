"""Nothing under ``benchmark/`` imports JAX or the JAX package (top-level
names compared whole: ``nbody_tpu_torch`` is not ``nbody_tpu``), and the
yardstick imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import catalog

from conftest import CELLS, SEED

FORBIDDEN = {"jax", "jaxlib", "flax", "nbody_tpu"}
YARDSTICK = ["inputs.py", "reference.py", "check.py", "roofline.py",
             "tracing.py", "catalog.py"]
FILES = sorted(p for p in catalog.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(catalog.HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(name):
    assert "nbody_tpu_torch" not in top_level_imports(catalog.HERE / name)


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from benchmark import run\n"
        f"run.run_cell({CELLS[3]!r}, {SEED}, 0.1, True, device_type='cpu',"
        " n=600)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        f" & set({sorted(FORBIDDEN)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=catalog.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
