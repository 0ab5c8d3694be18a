"""nbody_tpu_torch Simulation and npz checkpoints against nbody_tpu's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu.checkpoint as jckpt
import nbody_tpu_torch.checkpoint as tckpt
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.simulation import Simulation as JSimulation
from nbody_tpu.state import System as JSystem
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.simulation import Simulation, available_methods
from nbody_tpu_torch.state import system_from_numpy


# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)

CFG = {"G": 1.0, "softening": 0.1}


def shared(n=64, dim=3, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(n, dim)), 0.2 * rng.normal(size=(n, dim)),
            np.full(n, 1.0 / n))
    jsys = JSystem(*(jnp.asarray(a, jnp.float64) for a in arrs))
    return jsys, system_from_numpy(*arrs, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("integrator", ["leapfrog", "euler"])
def test_run_and_energy_match_jax(dim, integrator):
    jsys, tsys = shared(dim=dim)
    want = JSimulation.create(jsys, JGravity(**CFG), method="brute",
                              integrator=integrator).run(steps=5, dt=1e-3)
    have = Simulation.create(tsys, TGravity(**CFG), method="brute",
                             integrator=integrator).run(steps=5, dt=1e-3)
    assert have.step_count == want.step_count == 5
    np.testing.assert_allclose(have.system.positions.numpy(),
                               np.asarray(want.system.positions), rtol=1e-10)
    np.testing.assert_allclose(have.system.velocities.numpy(),
                               np.asarray(want.system.velocities), rtol=1e-10)
    ej, et = want.energy(), have.energy()
    for k in ("kinetic", "potential", "total"):
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-10)
    np.testing.assert_allclose(have.forces().numpy(),
                               np.asarray(want.forces()), rtol=1e-10)


def test_methods_unknown_and_unported():
    _, tsys = shared(n=8)
    assert available_methods() == ["barnes_hut", "brute", "fmm"]
    with pytest.raises(ValueError):
        Simulation.create(tsys, method="magic")
    with pytest.raises(ValueError):
        Simulation.create(tsys, integrator="rk9")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation.create(tsys, method="bvh")
    assert Simulation.create(tsys, method="fmm").method == "fmm"


def test_save_load_round_trip(tmp_path):
    _, tsys = shared(n=16)
    sim = Simulation.create(tsys, TGravity(**CFG)).run(steps=3, dt=1e-3)
    sim.save(str(tmp_path))
    back = Simulation.load(str(tmp_path), TGravity(**CFG), device="cpu")
    assert back.step_count == 3
    assert torch.equal(back.system.positions, sim.system.positions)
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path / "none"), device="cpu")


def test_checkpoint_jax_to_torch(tmp_path):
    jsys, _ = shared(n=12, dim=2)
    key = jax.random.key(123)
    jckpt.save_checkpoint(str(tmp_path), jsys, step=7, key=key,
                          use_orbax=False)
    system, step, tkey = tckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert step == 7 and tckpt.latest_step(str(tmp_path)) == 7
    np.testing.assert_array_equal(system.positions.numpy(),
                                  np.asarray(jsys.positions))
    np.testing.assert_array_equal(system.masses.numpy(),
                                  np.asarray(jsys.masses))
    np.testing.assert_array_equal(tkey, np.asarray(jax.random.key_data(key)))


def test_checkpoint_torch_to_jax(tmp_path):
    _, tsys = shared(n=12)
    key = jax.random.key(7)
    tckpt.save_checkpoint(str(tmp_path), tsys, step=2)
    tckpt.save_checkpoint(str(tmp_path), tsys, step=5,
                          key=np.asarray(jax.random.key_data(key)))
    system, step, jkey = jckpt.load_checkpoint(str(tmp_path))
    assert step == 5
    np.testing.assert_array_equal(np.asarray(system.velocities),
                                  tsys.velocities.numpy())
    # The restored key generates the same stream.
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(key, (4,))),
                                  np.asarray(jax.random.uniform(jkey, (4,))))
    _, _, none = jckpt.load_checkpoint(str(tmp_path), step=2)
    assert none is None
