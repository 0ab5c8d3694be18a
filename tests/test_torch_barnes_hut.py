"""The Barnes-Hut grid tier end to end (nbody_tpu_torch barnes_hut_grid,
Simulation("barnes_hut"), registry tier b) against the JAX package.

Tolerances: in f64 the two packages run the same operations on the same
tree, so forces agree to 1e-10 scale-normalized; in f32 each side rounds
its own sums, 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.bench import registry as jreg
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.ops.grid_tree import barnes_hut_grid as jax_bh
from nbody_tpu.simulation import Simulation as JSimulation
from nbody_tpu.state import System as JSystem
from nbody_tpu_torch import cli
from nbody_tpu_torch.bench import registry
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.config import TreeConfig
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.ops.grid_tree import barnes_hut_grid
from nbody_tpu_torch.simulation import Simulation
from nbody_tpu_torch.state import system_from_numpy
from nbody_tpu_torch.utils.accuracy import (accuracy_percentage,
                                            scale_normalized_error)


# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)


def _bodies(n, dim, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.0, 1e7, (n, dim)).astype(dtype),
            rng.uniform(1.0, 1e8, n).astype(dtype))


def _err(have, want):
    return float(scale_normalized_error(have, np.asarray(want)))


@pytest.mark.parametrize("theta", [0.5, 0.25])
@pytest.mark.parametrize("n", [256, 1000])
def test_barnes_hut_grid_matches_jax_f64(dim, n, theta):
    pos, mass = _bodies(n, dim, seed=n + dim)
    want = jax_bh(jnp.asarray(pos), jnp.asarray(mass), JGravity(),
                  theta=theta)
    have = barnes_hut_grid(torch.from_numpy(pos), torch.from_numpy(mass),
                           TGravity(), theta=theta)
    assert have.dtype == torch.float64 and have.shape == (n, dim)
    assert _err(have, want) < 1e-10


@pytest.mark.parametrize("theta", [0.5, 0.25])
def test_barnes_hut_grid_matches_jax_f32(dim, theta):
    pos, mass = _bodies(1000, dim, seed=7, dtype=np.float32)
    want = jax_bh(jnp.asarray(pos), jnp.asarray(mass), JGravity(),
                  theta=theta)
    have = barnes_hut_grid(torch.from_numpy(pos), torch.from_numpy(mass),
                           TGravity(), theta=theta)
    assert have.dtype == torch.float32
    assert _err(have, want) < 1e-5


def test_simulation_barnes_hut_matches_jax():
    """Three leapfrog steps of Simulation("barnes_hut") in G = 1 units,
    where the bodies move, against the JAX package's."""
    rng = np.random.default_rng(5)
    arrs = (rng.normal(size=(512, 2)), 0.2 * rng.normal(size=(512, 2)),
            np.full(512, 1.0 / 512))
    cfg = {"G": 1.0, "softening": 0.05}
    jsys = JSystem(*(jnp.asarray(a, jnp.float64) for a in arrs))
    tsys = system_from_numpy(*arrs, device="cpu", dtype=torch.float64)
    want = JSimulation.create(jsys, JGravity(**cfg), method="barnes_hut")\
        .run(steps=3, dt=1e-2)
    have = Simulation.create(tsys, TGravity(**cfg), method="barnes_hut")\
        .run(steps=3, dt=1e-2)
    assert have.step_count == 3 and have.method == "barnes_hut"
    np.testing.assert_allclose(have.system.positions.numpy(),
                               np.asarray(want.system.positions), rtol=1e-10)
    np.testing.assert_allclose(have.system.velocities.numpy(),
                               np.asarray(want.system.velocities),
                               rtol=1e-9, atol=1e-12)
    assert _err(have.forces(), want.forces()) < 1e-10


def test_tier_b_hyperparams_match_jax():
    cfg = TGravity()
    names = ("BarnesHut_Grid", "BarnesHut_Grid_Theta05")
    for n in (1000, 100_000, 1_000_000, 5_000_000):
        for dim in (2, 3):
            for name in names:
                assert registry.get(name).hyperparams(
                    n, dim, cfg, TreeConfig()) == jreg.get(name).hyperparams(
                    n, dim, JGravity(), None)
    assert registry.PORTED_TIERS == "abf"
    assert [m.tier for m in registry.methods_for_tiers("b", "cpu")] == \
        ["b", "b"]


def test_cli_tier_b_on_cpu(capsys):
    rc = cli.main(["-d", "3", "-N", "300", "-m", "b", "-a", "1",
                   "--device", "cpu", "--no-files", "--warmup", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "BarnesHut_Grid accuracy:" in out
    assert "BarnesHut_Grid_Theta05 accuracy:" in out


def test_force_sign_and_small_n_exact():
    """The JAX tests' analogues (tests/test_grid_tree.py:280-298): tree
    forces attract, and a tree with only a near field is the direct sum."""
    pos = torch.tensor([[0.0, 0.0], [10.0, 0.0]]
                       + [[100.0 + i, 100.0] for i in range(14)],
                       dtype=torch.float64)
    mass = torch.ones(16, dtype=torch.float64)
    unit = TGravity(G=1.0)
    got = barnes_hut_grid(pos, mass, unit)
    want = brute_force_direct(pos, mass, unit)
    assert float(got[0, 0]) > 0
    assert np.sign(float(got[0, 0])) == np.sign(float(want[0, 0]))
    p16, m16 = _bodies(16, 2, seed=3)
    tp, tm = torch.from_numpy(p16), torch.from_numpy(m16)
    np.testing.assert_allclose(barnes_hut_grid(tp, tm).numpy(),
                               brute_force_direct(tp, tm).numpy(), rtol=1e-6)


def test_quad_theta025_accuracy_2d():
    """The reference metric at θ = 0.25 with quadrupole cells clears 99% at
    8192 bodies in 2D, fp32 (tests/test_grid_tree.py:114-122)."""
    pos, mass = _bodies(8192, 2, seed=0, dtype=np.float32)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    got = barnes_hut_grid(tp, tm, theta=0.25, leaf_level=4, multipole="quad")
    want = brute_force_direct(tp.double(), tm.double())
    assert float(accuracy_percentage(got.double(), want)) >= 99.0
    assert float(scale_normalized_error(got.double(), want)) < 1e-3


def test_quadrupole_beats_monopole():
    """tests/test_grid_tree.py:97-111: quadrupole cells cut the far-field
    error at least in half against monopoles at the same θ."""
    pos, mass = _bodies(4096, 2, seed=2)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    want = brute_force_direct(tp, tm)
    errs = [float(scale_normalized_error(barnes_hut_grid(
        tp, tm, theta=0.5, leaf_level=3, multipole=m), want))
        for m in ("mono", "quad")]
    assert errs[1] < 0.5 * errs[0], errs
