"""nbody_tpu_torch.integrators against nbody_tpu.integrators (f64, G = 1)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu.integrators as jint
import nbody_tpu_torch.integrators as tint
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.ops.brute_force import brute_force_direct as j_direct
from nbody_tpu.ops.brute_force import kinetic_energy as j_ke
from nbody_tpu.ops.brute_force import potential_energy as j_pe
from nbody_tpu.state import System as JSystem
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops.brute_force import brute_force_direct as t_direct
from nbody_tpu_torch.ops.brute_force import kinetic_energy as t_ke
from nbody_tpu_torch.ops.brute_force import potential_energy as t_pe
from nbody_tpu_torch.state import system_from_numpy

CFG = {"G": 1.0, "softening": 0.1}


def shared_system(n=48, dim=3, seed=0):
    """A warm Plummer-like cluster in G = 1 units, from numpy."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, dim))
    vel = 0.3 * rng.normal(size=(n, dim))
    mass = np.full(n, 1.0 / n)
    jsys = JSystem(*(jnp.asarray(a, jnp.float64) for a in (pos, vel, mass)))
    tsys = system_from_numpy(pos, vel, mass, device="cpu",
                             dtype=torch.float64)
    return jsys, tsys


def forces():
    return (functools.partial(j_direct, config=JGravity(**CFG)),
            functools.partial(t_direct, config=TGravity(**CFG)))


def assert_same_state(tsys, jsys, rtol=1e-10):
    np.testing.assert_allclose(tsys.positions.numpy(),
                               np.asarray(jsys.positions), rtol=rtol)
    np.testing.assert_allclose(tsys.velocities.numpy(),
                               np.asarray(jsys.velocities), rtol=rtol)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_simulate_matches_jax(dim, integrator):
    jsys, tsys = shared_system(dim=dim)
    jf, tf = forces()
    want, _ = jint.simulate(jsys, jf, 1e-3, 8, integrator=integrator)
    have, none = tint.simulate(tsys, tf, 1e-3, 8, integrator=integrator)
    assert none is None
    assert_same_state(have, want)


def test_single_steps_match_jax():
    jsys, tsys = shared_system()
    jf, tf = forces()
    for jstep, tstep in [(jint.euler_step, tint.euler_step),
                         (jint.leapfrog_step, tint.leapfrog_step)]:
        assert_same_state(tstep(tsys, tf, 1e-2), jstep(jsys, jf, 1e-2))
    ja = jf(jsys.positions, jsys.masses) / jsys.masses[:, None]
    ta = tf(tsys.positions, tsys.masses) / tsys.masses[:, None]
    jnext, ja1 = jint.leapfrog_step_carried(jsys, ja, jf, 1e-2)
    tnext, ta1 = tint.leapfrog_step_carried(tsys, ta, tf, 1e-2)
    assert_same_state(tnext, jnext)
    np.testing.assert_allclose(ta1.numpy(), np.asarray(ja1), rtol=1e-10)


def test_carried_leapfrog_equals_chained():
    _, tsys = shared_system(n=64)
    _, tf = forces()
    want = tsys
    for _ in range(5):
        want = tint.leapfrog_step(want, tf, 1e-2)
    have, _ = tint.simulate(tsys, tf, 1e-2, 5)
    assert_same_state(have, want, rtol=1e-13)


def test_energy_matches_jax_and_is_conserved():
    jsys, tsys = shared_system(n=64)
    jc, tc = JGravity(**CFG), TGravity(**CFG)

    def t_energy(s):
        return float(t_ke(s.velocities, s.masses)
                     + t_pe(s.positions, s.masses, tc))

    e_jax = float(j_ke(jsys.velocities, jsys.masses)
                  + j_pe(jsys.positions, jsys.masses, jc))
    e0 = t_energy(tsys)
    np.testing.assert_allclose(e0, e_jax, rtol=1e-12)
    _, tf = forces()
    final, _ = tint.simulate(tsys, tf, 1e-3, 100)
    assert abs(t_energy(final) - e0) / abs(e0) < 1e-3
