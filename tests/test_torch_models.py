"""The port's scenario models (nbody_tpu_torch.models) against the JAX
package's nbody_tpu.models: the deterministic scenarios equal the JAX
arrays exactly (f64); the random ones hold the JAX tests' statistical and
physical bounds (tests/test_models.py), since torch cannot draw the
jax.random streams. Dynamics run on the CPU in f64 through the port's
simulate and brute_force_direct, at the JAX tests' tolerances.
"""

import functools
import math

import numpy as np
import pytest
import torch

from nbody_tpu import models as jmodels
from nbody_tpu_torch import models
from nbody_tpu_torch.integrators import simulate
from nbody_tpu_torch.ops.brute_force import brute_force_direct

CPU = torch.device("cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def forces_for(cfg):
    return functools.partial(brute_force_direct, config=cfg)


def _angular_momentum(s):
    return float(torch.sum(s.masses * (s.positions[:, 0] * s.velocities[:, 1]
                                       - s.positions[:, 1]
                                       * s.velocities[:, 0])))


@pytest.mark.parametrize("build", ["two_body_circular_orbit",
                                   "solar_system"])
def test_deterministic_scenarios_equal_jax(build):
    have, hcfg = getattr(models, build)(CPU)
    want, wcfg = getattr(jmodels, build)()
    for f in ("positions", "velocities", "masses"):
        h = getattr(have, f)
        assert h.dtype == torch.float64 and h.device == CPU
        np.testing.assert_array_equal(h.numpy(), np.asarray(getattr(want, f)))
    assert (hcfg.G, hcfg.softening) == (wcfg.G, wcfg.softening)


def test_uniform_random_matches_reference_distribution():
    s, cfg = models.uniform_random(256, generator=_gen(), device=CPU)
    assert cfg.G == 4.471e-21
    assert s.positions.shape == (256, 3) and s.dtype == torch.float32
    assert float(s.positions.max()) <= 1e7 and float(s.positions.min()) >= 1
    assert 1 <= float(s.masses.min()) and float(s.masses.max()) <= 1e8
    assert float(s.velocities.abs().max()) <= 10


def test_two_body_orbit_closes():
    """One full period of the analytic binary returns to the start."""
    s, cfg = models.two_body_circular_orbit(CPU)
    period = 4.0 * np.pi
    steps = 2000
    final, _ = simulate(s, forces_for(cfg), dt=period / steps,
                        num_steps=steps, integrator="leapfrog")
    np.testing.assert_allclose(final.positions.numpy(), s.positions.numpy(),
                               atol=5e-3)
    sep = float(torch.linalg.norm(final.positions[0] - final.positions[1]))
    np.testing.assert_allclose(sep, 2.0, rtol=1e-3)


def test_spiral_galaxy_angular_momentum():
    s, cfg = models.spiral_galaxy(200, generator=_gen(1), device=CPU,
                                  dtype=torch.float64)
    assert s.positions.shape == (200, 2) and cfg.G == 1.0
    assert math.isclose(float(s.masses.sum()), 1.0, rel_tol=1e-12)
    L0 = _angular_momentum(s)
    assert L0 > 0.05  # a rotating disk
    final, _ = simulate(s, forces_for(cfg), dt=1e-3, num_steps=100,
                        integrator="leapfrog")
    np.testing.assert_allclose(_angular_momentum(final), L0, rtol=1e-5)


def test_solar_system_earth_period():
    """Earth (index 3) completes one orbit in t = 1 yr (G = 4π² units)."""
    s, cfg = models.solar_system(CPU)
    steps = 3000
    final, _ = simulate(s, forces_for(cfg), dt=1.0 / steps, num_steps=steps,
                        integrator="leapfrog")
    np.testing.assert_allclose(final.positions[3].numpy(),
                               s.positions[3].numpy(), atol=2e-2)


def test_plummer_sphere_units():
    s, cfg = models.plummer_sphere(300, generator=_gen(2), device=CPU,
                                   dtype=torch.float64)
    assert np.isclose(float(s.masses.sum()), 1.0, rtol=1e-6)
    assert (cfg.G, cfg.softening) == (1.0, 4.0 / 300)
    assert float(s.velocities.abs().max()) == 0.0  # cold start
    # Half the mass inside the Plummer half-mass radius, 1.305 a.
    r = torch.linalg.norm(s.positions, dim=1)
    assert 0.4 < float((r < 1.305).double().mean()) < 0.6
