"""The port's device-step bench (nbody_tpu_torch.tools.device_step_bench)
on the CPU against the JAX tool's adapters (tools/device_step_bench.py,
``jittable_force_fn``) on the same numpy bodies.

Tolerances (scale-normalized): brute force 1e-4, the JAX kernel tests'
own; the trees 1e-5, the port's tier tests' fp32 bound against the JAX
package (tests/test_torch_barnes_hut.py, test_torch_fmm.py: each side
rounds its own sums). Euler steps against the JAX package's
``simulate(integrator="euler")``: 1e-5 of the largest value, fp32.
BruteForce_CUDA's adapter runs its kernel's plain version here (CPU
tensors), held to the JAX adapter's kernel in interpret mode. The CUDA
graph path needs a card (tests marked ``cuda``).
"""

import csv
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import device_step_bench as jdsb  # noqa: E402  (the JAX tool)
from nbody_tpu.config import GravityConfig as JGravity  # noqa: E402
from nbody_tpu.integrators import simulate as jsimulate  # noqa: E402
from nbody_tpu.ops.pallas_brute import brute_force_pallas  # noqa: E402
from nbody_tpu.state import System as JSystem  # noqa: E402
from nbody_tpu_torch.config import GravityConfig as TGravity  # noqa: E402
from nbody_tpu_torch.state import system_from_numpy  # noqa: E402
from nbody_tpu_torch.tools import device_step_bench as dsb  # noqa: E402
from nbody_tpu_torch.utils.accuracy import \
    scale_normalized_error  # noqa: E402

torch.set_num_threads(2)

# The port's adapter name -> the JAX tool's.
JAX_NAME = {"BruteForce_Torch": "BruteForce_JNP",
            "BruteForce_CUDA": "BruteForce_Pallas",
            "BarnesHut_Grid": "BarnesHut_Grid",
            "BarnesHut_Grid_Theta05": "BarnesHut_Grid_Theta05",
            "BVH_Radix": "BVH_Radix", "FMM_Chebyshev": "FMM_Chebyshev"}
TOL = {"BruteForce_Torch": 1e-4, "BruteForce_CUDA": 1e-4}


def _reference_bodies(n, dim, seed):
    """fp32 bodies of the reference distribution (utils.h ranges)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 1e7, (n, dim)).astype(np.float32)
    vel = rng.uniform(-10.0, 10.0, (n, dim)).astype(np.float32)
    mass = rng.uniform(1.0, 1e8, n).astype(np.float32)
    return pos, vel, mass


def _jax_forces(name, pos, mass):
    p, m = jnp.asarray(pos), jnp.asarray(mass)
    if name == "BruteForce_CUDA":
        # The JAX tool's adapter: K1's Pallas kernel, here interpreted.
        return brute_force_pallas(p, m, JGravity(), mode="symmetric",
                                  interpret=True)
    return jdsb.jittable_force_fn(JAX_NAME[name], p, m, JGravity())(p, m)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", dsb.ADAPTERS)
def test_adapter_matches_the_jax_tools(name, dim):
    pos, vel, mass = _reference_bodies(512, dim, seed=dim)
    s = system_from_numpy(pos, vel, mass, "cpu")
    fn = dsb.step_force_fn(name, s.positions, s.masses, TGravity())
    have = fn(s.positions, s.masses)
    want = np.array(_jax_forces(name, pos, mass))
    assert have.dtype == torch.float32 and have.shape == (512, dim)
    assert bool(torch.isfinite(have).all())
    err = float(scale_normalized_error(have.double(),
                                       torch.from_numpy(want).double()))
    assert err < TOL.get(name, 1e-5), err


def test_eager_euler_steps_match_the_jax_simulate():
    """K Euler steps of the plain adapter in G = 1 units, where the bodies
    move, against the JAX package's simulate(integrator="euler") with the
    JAX tool's adapter."""
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(512, 3)).astype(np.float32)
    vel = (0.1 * rng.normal(size=(512, 3))).astype(np.float32)
    mass = np.full(512, 1.0 / 512, np.float32)
    cfg = {"G": 1.0, "softening": 0.05}
    k, dt = 4, 1e-2
    s = system_from_numpy(pos, vel, mass, "cpu")
    fn = dsb.step_force_fn("BruteForce_Torch", s.positions, s.masses,
                           TGravity(**cfg))
    have = dsb.euler_steps(fn, s, k, dt)
    js = JSystem(positions=jnp.asarray(pos), velocities=jnp.asarray(vel),
                 masses=jnp.asarray(mass))
    jfn = jdsb.jittable_force_fn("BruteForce_JNP", js.positions, js.masses,
                                 JGravity(**cfg))
    want, _ = jsimulate(js, forces_fn=jfn, dt=dt, num_steps=k,
                        integrator="euler")
    for h, w in ((have.positions, want.positions),
                 (have.velocities, want.velocities)):
        w = np.asarray(w)
        np.testing.assert_allclose(h.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert float((have.positions - s.positions).abs().max()) > 1e-4


@pytest.fixture
def short_runs(monkeypatch):
    """The estimator's budgets cut to a few steps a run on the CPU."""
    monkeypatch.setattr(dsb, "DISPATCH_BUDGET_S", 1e-3)
    monkeypatch.setattr(dsb, "PROBE_SIGNAL_S", 1e-4)


@pytest.mark.parametrize("slow_step", [0.0, 1e9])  # ladder skipped, run
@pytest.mark.parametrize("name", ["BruteForce_Torch", "FMM_Chebyshev"])
def test_measure_returns_a_differenced_step_time(short_runs, monkeypatch,
                                                 name, slow_step):
    monkeypatch.setattr(dsb, "SLOW_STEP_S", slow_step)
    pos, vel, mass = _reference_bodies(256, 2, seed=5)
    s = system_from_numpy(pos, vel, mass, "cpu")
    t, k, launches = dsb.measure(name, s, TGravity(), graph=False,
                                 repeats=1)
    assert t > 0 and k >= 1 and launches == {}


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_keyed_csv_replaces_a_row_in_place(short_runs, tmp_path, capsys):
    out = str(tmp_path / "device_step_times.csv")
    with open(out, "w") as f:  # a JAX-schema file: five columns
        f.write("Bodies,Method,Dimension,StepTime(s),Steps\n"
                "64,BruteForce_Torch,2,9.0e+00,7\n"
                "64,BVH_Radix,2,1.0e+00,7\n")
    run = functools.partial(dsb.main, ["-N", "64", "--dim", "2", "--methods",
                                       "BruteForce_Torch", "--device", "cpu",
                                       "--repeats", "1", "--out", out])
    assert run() == 0
    rows = _rows(out)
    assert [(r["Bodies"], r["Method"]) for r in rows] == [
        ("64", "BVH_Radix"), ("64", "BruteForce_Torch")]
    fresh = rows[1]
    assert float(fresh["StepTime(s)"]) != 9.0
    assert fresh["Dispatch"] == "eager"
    assert rows[0]["StepTime(s)"] == "1.0e+00"  # untouched
    assert run() == 0
    assert len(_rows(out)) == 2
    assert "1 rows refreshed" in capsys.readouterr().out


def test_non_finite_forces_are_an_error_row(short_runs, tmp_path,
                                            monkeypatch):
    out = str(tmp_path / "t.csv")
    monkeypatch.setattr(dsb, "step_force_fn", lambda *a: (
        lambda p, m: torch.full_like(p, float("nan"))))
    assert dsb.main(["-N", "32", "--dim", "2", "--methods", "BVH_Radix",
                     "--device", "cpu", "--out", out]) == 1
    assert not os.path.exists(out)  # nothing timed, nothing written


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert dsb.main(["-N", "8"]) == 2


def test_graph_steps_need_a_card():
    s = system_from_numpy(*_reference_bodies(8, 2, seed=1), "cpu")
    with pytest.raises(ValueError, match="card"):
        dsb.GraphSteps(lambda p, m: p, s)


@pytest.mark.cuda
@pytest.mark.parametrize("name", dsb.GRAPH_METHODS)
def test_graph_replay_matches_eager_steps_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    s = system_from_numpy(rng.normal(size=(3000, 3)).astype(np.float32),
                          np.zeros((3000, 3), np.float32),
                          np.full(3000, 1 / 3000, np.float32), "cuda")
    fn = dsb.step_force_fn(name, s.positions, s.masses,
                           TGravity(G=1.0, softening=0.05))
    want = dsb.euler_steps(fn, s, 8, 1e-3)
    got = dsb.GraphSteps(fn, s, 1e-3).run(8)
    if name == "BruteForce_Torch":
        assert torch.equal(got.positions, want.positions)
    else:  # K1 adds in fp64 atomics, in no fixed order
        torch.testing.assert_close(got.positions, want.positions, rtol=0,
                                   atol=1e-5 * float(want.positions.abs()
                                                     .max()))
