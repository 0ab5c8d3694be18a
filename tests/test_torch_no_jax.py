"""nbody_tpu_torch must never import JAX, nor the JAX package nbody_tpu
(not even a module of it that imports no JAX)."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "nbody_tpu_torch"

_PROBE = r"""
import pkgutil
import sys

import nbody_tpu_torch

mods = ["nbody_tpu_torch"] + [
    info.name for info in pkgutil.walk_packages(
        nbody_tpu_torch.__path__, prefix="nbody_tpu_torch.")]
for name in mods:
    __import__(name)
for name in ("nbody_tpu_torch.ops.fmm", "nbody_tpu_torch.ops.sparse_grid"):
    assert name in mods, name
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not jax_mods, jax_mods
ref_mods = sorted(m for m in sys.modules
                  if m == "nbody_tpu" or m.startswith("nbody_tpu."))
assert not ref_mods, ref_mods
print("OK", len(mods))
"""


def test_importing_every_module_leaves_jax_out():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[1])
    assert n >= 15  # the package, its subpackages and their modules


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 15
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


# ``nbody_tpu`` followed by a word character is ``nbody_tpu_torch``.
_REF_IMPORT = re.compile(
    r"^\s*(import|from)\s+nbody_tpu\b|import_module\(\s*['\"]nbody_tpu\b",
    re.M)


def test_no_source_file_imports_the_jax_package():
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if _REF_IMPORT.search(f.read_text())]
    assert not offenders
    assert _REF_IMPORT.search("from nbody_tpu.ops.keys import quantize")
    assert _REF_IMPORT.search("    import nbody_tpu")
    assert not _REF_IMPORT.search("from nbody_tpu_torch.ops import keys")
