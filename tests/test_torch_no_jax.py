"""nbody_tpu_torch must never import JAX, nor the JAX package nbody_tpu
(not even a module of it that imports no JAX)."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "nbody_tpu_torch"

_PROBE = r"""
import importlib.abc
import pkgutil
import sys


class _Block(importlib.abc.MetaPathFinder):
    # Refuse jax and the JAX package outright, not only afterwards.
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "nbody_tpu"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Block())

import nbody_tpu_torch

mods = ["nbody_tpu_torch"] + [
    info.name for info in pkgutil.walk_packages(
        nbody_tpu_torch.__path__, prefix="nbody_tpu_torch.")]
for name in mods:
    __import__(name)
for name in ("nbody_tpu_torch.ops.fmm", "nbody_tpu_torch.ops.sparse_grid",
             "nbody_tpu_torch.ops.bvh", "nbody_tpu_torch.parallel",
             "nbody_tpu_torch.parallel.mesh", "nbody_tpu_torch.parallel.ring",
             "nbody_tpu_torch.parallel.sharded_tree",
             "nbody_tpu_torch.parallel.dryrun",
             "nbody_tpu_torch.utils.device_mesh",
             "nbody_tpu_torch.parallel.let_tree",
             "nbody_tpu_torch.parallel.let_bvh", "nbody_tpu_torch.models",
             "nbody_tpu_torch.models.scenarios",
             "nbody_tpu_torch.utils.profiling",
             "nbody_tpu_torch.utils.native", "nbody_tpu_torch.bench.sweep",
             "nbody_tpu_torch.bench.analysis",
             "nbody_tpu_torch.tools.common",
             "nbody_tpu_torch.tools.device_step_bench",
             "nbody_tpu_torch.tools.simulate_1m",
             "nbody_tpu_torch.tools.method_smoke",
             "nbody_tpu_torch.tools.run_full_sweep",
             "nbody_tpu_torch.tools.prune_superseded",
             "nbody_tpu_torch.tools.compare_vs_baseline",
             "nbody_tpu_torch.tools.multichip_scaling",
             "nbody_tpu_torch.tools.tree_phase_bench",
             "nbody_tpu_torch.tools.clustered_stress",
             "nbody_tpu_torch.tools.clustered_phase",
             "nbody_tpu_torch.tools.bh_bigN_probe",
             "nbody_tpu_torch.tools.bh_near_probe",
             "nbody_tpu_torch.tools.bh_tune",
             "nbody_tpu_torch.tools.bvh_bench",
             "nbody_tpu_torch.tools.bvh_far_flip_probe",
             "nbody_tpu_torch.tools.local_leaf_check",
             "nbody_tpu_torch.tools.smalln_floor",
             "nbody_tpu_torch.tools.brute_variants",
             "nbody_tpu_torch.tools.mxu_narrow_bench",
             "nbody_tpu_torch.examples",
             "nbody_tpu_torch.examples.galaxy_demo",
             "nbody_tpu_torch.examples.multichip_ring"):
    assert name in mods, name
# Running the ring and a sharded tier on a CPU mesh, not only importing
# them, loads no JAX either.
import torch
from nbody_tpu_torch.parallel import make_mesh, ring_brute_force
from nbody_tpu_torch.parallel.sharded_tree import fmm_sharded
mesh = make_mesh([torch.device("cpu")] * 2)
pos = torch.rand((64, 3), dtype=torch.float64)
ring_brute_force(pos, torch.ones(64, dtype=torch.float64), mesh=mesh)
fmm_sharded(pos, torch.ones(64, dtype=torch.float64), mesh=mesh, order=3)
from nbody_tpu_torch.parallel import let_barnes_hut, let_bvh, let_fmm
from nbody_tpu_torch.models import two_body_circular_orbit
for let in (let_barnes_hut, let_fmm, let_bvh):
    let(pos, torch.ones(64, dtype=torch.float64), mesh=mesh)
two_body_circular_orbit("cpu")
with mesh.census() as census:
    ring_brute_force(pos, torch.ones(64, dtype=torch.float64), mesh=mesh,
                     symmetric=False)
assert census["rotate"]["count"] == 1, census
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
