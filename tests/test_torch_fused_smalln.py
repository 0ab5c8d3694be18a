"""K4's plain version (nbody_tpu_torch.ops.cuda_brute.fused_smalln_*)
against the JAX Pallas fused small-N integrator, run in interpret mode.

K4 itself runs only on the card (``chip_smoke.py``); here the wrapper gets
CPU tensors and takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.pallas_brute import fused_smalln_simulate as j_fused
from nbody_tpu_torch.config import G_DEFAULT, SOFTENING
from nbody_tpu_torch.ops import cuda_brute as cb


def _reference_units(n, dim, seed):
    """The reference distribution (utils.h:113-115), G = 4.471e-21."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 1e7, size=(n, dim)).astype(np.float32)
    vel = rng.uniform(-10.0, 10.0, size=(n, dim)).astype(np.float32)
    mass = rng.uniform(1.0, 1e8, size=n).astype(np.float32)
    return (pos, vel, mass), {"g": G_DEFAULT, "softening": SOFTENING,
                              "dt": 1e-6, "num_steps": 8}


def _plummer_units(n, dim, seed):
    """A warm cluster in G = 1 units at softening 0.1: bodies move."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, dim)).astype(np.float32)
    vel = (0.3 * rng.normal(size=(n, dim))).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    return (pos, vel, mass), {"g": 1.0, "softening": 0.1, "dt": 1e-3,
                              "num_steps": 16}


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("make,n,dim,moves", [
    (_reference_units, 300, 2, False), (_plummer_units, 200, 3, True)])
def test_fused_plain_matches_pallas(make, n, dim, moves, integrator):
    """Both run the same per-step operation order in fp32 and differ only in
    the order of each force sum, which moves an acceleration by a few fp32
    ulps. Over 16 steps of dt 1e-3 that shifts velocities and positions by
    ~1e-8 of their largest value (measured on the CPU); the bound is 1e-6
    of it. In reference units the steps do not move the state at fp32
    resolution at all, as the JAX package's own test records."""
    arrays, kw = make(n, dim, seed=n)
    want = j_fused(*map(jnp.asarray, arrays), integrator=integrator,
                   interpret=True, **kw)
    have = cb.fused_smalln_simulate(*map(torch.from_numpy, arrays),
                                    integrator=integrator, **kw)
    moved = False
    for h, w, start in zip(have, want, arrays):
        w = np.asarray(w)
        assert h.dtype == torch.float32 and h.shape == (n, dim)
        np.testing.assert_allclose(h.numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()))
        moved |= not np.array_equal(w, start)
    assert moved == moves


def test_fused_wrapper_is_plain_on_cpu_and_launches_nothing():
    arrays, kw = _plummer_units(64, 2, seed=1)
    tensors = list(map(torch.from_numpy, arrays))
    before = dict(cb.LAUNCHES)
    have = cb.fused_smalln_simulate(*tensors, integrator="leapfrog", **kw)
    want = cb.fused_smalln_plain(*tensors, integrator="leapfrog", **kw)
    assert cb.LAUNCHES == before
    for h, w in zip(have, want):
        assert torch.equal(h, w)


def test_fused_guard_default_keeps_coincident_bodies_finite():
    """softening == 0 turns the pair guard on (the JAX default)."""
    pos = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 0.0]], np.float32)
    vel = np.zeros_like(pos)
    mass = np.ones(3, np.float32)
    kw = {"dt": 1e-3, "num_steps": 4, "g": 1.0, "softening": 0.0}
    want = j_fused(*map(jnp.asarray, (pos, vel, mass)), interpret=True, **kw)
    have = cb.fused_smalln_simulate(*map(torch.from_numpy, (pos, vel, mass)),
                                    **kw)
    for h, w in zip(have, want):
        assert bool(torch.isfinite(h).all())
        np.testing.assert_allclose(h.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)


def test_fused_rejects_big_n_and_bad_integrator():
    n = cb.FUSED_SMALLN_MAX + 1
    with pytest.raises(ValueError, match="fused_smalln"):
        cb.fused_smalln_simulate(torch.zeros((n, 2)), torch.zeros((n, 2)),
                                 torch.ones(n), dt=1e-6, num_steps=1)
    with pytest.raises(ValueError, match="integrator"):
        cb.fused_smalln_simulate(torch.zeros((4, 2)), torch.zeros((4, 2)),
                                 torch.ones(4), dt=1e-6, num_steps=1,
                                 integrator="rk4")
