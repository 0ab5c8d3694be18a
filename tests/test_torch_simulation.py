"""nbody_tpu_torch Simulation and npz checkpoints against nbody_tpu's."""

import dataclasses
import functools

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
from nbody_tpu_torch.integrators import euler_step, leapfrog_step
from nbody_tpu_torch.ops.brute_force import brute_force_blocked
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
    assert available_methods() == ["barnes_hut", "brute", "bvh", "fmm"]
    with pytest.raises(ValueError):
        Simulation.create(tsys, method="magic")
    with pytest.raises(ValueError):
        Simulation.create(tsys, integrator="rk9")
    assert Simulation.create(tsys, method="fmm").method == "fmm"
    # Every method of the JAX package is ported: "bvh" builds and runs.
    sim = Simulation.create(tsys, TGravity(**CFG), method="bvh")
    assert sim.forces_fn.keywords["leaf_size"] == 16
    ran = sim.run(steps=1, dt=1e-3)
    assert ran.step_count == 1 and bool(
        torch.isfinite(ran.system.positions).all())


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


@pytest.fixture
def spans():
    """The span registry empty and off before and after the test."""
    from nbody_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield profiling
    profiling.reset_spans()


def test_run_spans_a_step_and_its_force_calls(spans):
    _, tsys = shared(n=64)
    sim = Simulation.create(tsys, TGravity(**CFG), method="brute")
    spans.enable_spans()
    sim.run(steps=1, dt=1e-3)
    totals = spans.span_totals()
    assert set(totals) == {"sim.step", "sim.force"}
    assert totals["sim.step"][1] == 1 and totals["sim.force"][1] == 2
    assert totals["sim.step"][0] >= totals["sim.force"][0] > 0
    spans.reset_spans()
    Simulation.create(tsys, TGravity(**CFG), method="brute",
                      integrator="euler").run(steps=3, dt=1e-3)
    assert spans.span_totals() == {}


@pytest.mark.parametrize("method", ["brute", "bvh"])
def test_run_bit_identical_with_spans_on(spans, method):
    _, tsys = shared(n=300, seed=2)
    sim = Simulation.create(tsys, TGravity(**CFG), method=method)
    off = sim.run(steps=2, dt=1e-3).system
    spans.enable_spans()
    on = sim.run(steps=2, dt=1e-3).system
    assert torch.equal(on.positions, off.positions)
    assert torch.equal(on.velocities, off.velocities)
    # A fresh handle's two steps: F(x0), F(x1), then F(x2); F(x1) carried.
    assert spans.span_totals()["sim.force"][1] == 3


class Counted:
    """``fn`` with a count of its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, positions, masses):
        self.calls += 1
        return self.fn(positions, masses)


K = 3


@pytest.mark.parametrize("method,integrator,calls", [
    ("brute", "leapfrog", 1 + K), ("bvh", "leapfrog", 1 + K),
    # Euler never evaluates at its new positions: nothing to carry.
    ("brute", "euler", K)])
def test_chained_runs_carry_the_forces(method, integrator, calls):
    _, tsys = shared(n=300, seed=5)
    sim = Simulation.create(tsys, TGravity(**CFG), method=method,
                            integrator=integrator)
    plain = sim.forces_fn
    step = leapfrog_step if integrator == "leapfrog" else euler_step
    want = tsys
    for _ in range(K):
        want = step(want, plain, 1e-3)
    whole = dataclasses.replace(sim, forces_fn=Counted(plain)).run(
        steps=K, dt=1e-3)
    chained = dataclasses.replace(sim, forces_fn=Counted(plain))
    for _ in range(K):
        chained = chained.run(steps=1, dt=1e-3)
    for got in (whole, chained):
        assert got.forces_fn.calls == calls and got.step_count == K
        assert torch.equal(got.system.positions, want.positions)
        assert torch.equal(got.system.velocities, want.velocities)


@pytest.mark.parametrize("way", ["system", "forces_fn", "in_place", "load"])
def test_carry_dropped(spans, way, tmp_path):
    _, tsys = shared(n=64, seed=3)
    sim = Simulation.create(tsys, TGravity(**CFG)).run(steps=2, dt=1e-3)
    assert sim.carried.positions is sim.system.positions
    if way == "system":
        sim = dataclasses.replace(sim, system=shared(n=64, seed=4)[1])
    elif way == "forces_fn":
        sim = dataclasses.replace(sim, forces_fn=Counted(functools.partial(
            brute_force_blocked, config=TGravity(G=1.0, softening=0.2))))
    elif way == "in_place":
        sim.system.positions.mul_(1.01)
    else:
        sim.save(str(tmp_path))
        sim = Simulation.load(str(tmp_path), TGravity(**CFG), device="cpu")
        assert sim.carried is None
    spans.enable_spans()
    got = sim.run(steps=1, dt=1e-3).system
    assert spans.span_totals()["sim.force"][1] == 2
    assert "sim.carried" not in spans.counter_totals()
    if way == "forces_fn":
        assert sim.forces_fn.calls == 2
    want = leapfrog_step(sim.system, sim.forces_fn, 1e-3)
    assert torch.equal(got.positions, want.positions)
    assert torch.equal(got.velocities, want.velocities)


def test_runs_from_one_handle_share_no_carry():
    _, tsys = shared(n=64, seed=6)
    sim = Simulation.create(tsys, TGravity(**CFG))
    sim = dataclasses.replace(sim, forces_fn=Counted(sim.forces_fn)).run(
        steps=1, dt=1e-3)
    carried, sim.forces_fn.calls = sim.carried, 0
    a, b = sim.run(steps=2, dt=1e-3), sim.run(steps=2, dt=1e-3)
    # Each run starts from the handle's own carry: one call a step.
    assert sim.forces_fn.calls == 4 and sim.carried is carried
    assert a.carried is not b.carried
    assert torch.equal(a.system.positions, b.system.positions)
    assert torch.equal(a.system.velocities, b.system.velocities)


def test_carried_counter_counts_the_hits(spans):
    _, tsys = shared(n=64, seed=7)
    sim = Simulation.create(tsys, TGravity(**CFG))
    sim.run(steps=3, dt=1e-3)
    assert spans.counter_totals() == {}
    spans.enable_spans()
    sim = sim.run(steps=3, dt=1e-3).run(steps=1, dt=1e-3)
    assert spans.counter_totals() == {"sim.carried": 3}
    assert spans.span_totals()["sim.force"][1] == 5
    Simulation.create(tsys, TGravity(**CFG), integrator="euler").run(
        steps=3, dt=1e-3)
    assert spans.counter_totals() == {"sim.carried": 3}
