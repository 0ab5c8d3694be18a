"""nbody_tpu_torch.ops.brute_force against nbody_tpu.ops.brute_force."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu.ops.brute_force as jbf
import nbody_tpu_torch.ops.brute_force as tbf
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.utils.accuracy import scale_normalized_error


# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)


def _bodies(n, dim, dtype, seed=0):
    """Reference-distribution bodies (utils.h:113-115) from numpy."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 1e7, size=(n, dim)).astype(dtype)
    vel = rng.uniform(-10.0, 10.0, size=(n, dim)).astype(dtype)
    mass = rng.uniform(1.0, 1e8, size=n).astype(dtype)
    return pos, vel, mass


def _both(fn_name, *arrays, **kw):
    jcfg = {k: JGravity(**v) for k, v in kw.pop("cfg", {}).items()}
    tcfg = {k: TGravity(**v) for k, v in kw.pop("cfg_t", {}).items()}
    want = getattr(jbf, fn_name)(*[jnp.asarray(a) for a in arrays],
                                 **jcfg, **kw)
    have = getattr(tbf, fn_name)(*[torch.from_numpy(a) for a in arrays],
                                 **tcfg, **kw)
    return want, have


def _np(x):
    return tuple(map(_np, x)) if isinstance(x, tuple) else np.asarray(x)


@pytest.mark.parametrize("softening", [0.0, 1e-6, 10.0])
def test_force_functions_f64(dim, softening):
    pos, _, mass = _bodies(150, dim, np.float64)
    c = {"config": {"softening": softening}}
    for name, kw in [("brute_force_accelerations", {}),
                     ("brute_force_direct", {}),
                     ("brute_force_blocked", {"block_size": 64}),
                     ("potential_energy", {})]:
        want, have = _both(name, pos, mass, cfg=c, cfg_t=c, **kw)
        np.testing.assert_allclose(_np(have.numpy()), _np(want), rtol=1e-12,
                                   err_msg=name)


def test_row_kernels_f64(dim):
    pos, _, mass = _bodies(96, dim, np.float64)
    t, tm, s, sm = pos[:40], mass[:40], pos[40:], mass[40:]
    want, have = _both("_accel_rows", t, s, sm, softening=1e-6)
    np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-12)
    want, have = _both("_accel_rows_sym", t, tm, s, sm, softening=1e-6)
    for h, w in zip(have, want):
        np.testing.assert_allclose(h.numpy(), np.asarray(w), rtol=1e-12)


@pytest.mark.parametrize("n,block", [(300, 128), (256, 64)])
def test_energies_f64(dim, n, block):
    pos, vel, mass = _bodies(n, dim, np.float64)
    c = {"config": {"G": 1.0, "softening": 0.05}}
    want, have = _both("potential_energy_blocked", pos, mass, cfg=c, cfg_t=c,
                       block_size=block)
    np.testing.assert_allclose(float(have), float(want), rtol=1e-12)
    dense, _ = _both("potential_energy", pos, mass, cfg=c, cfg_t=c)
    np.testing.assert_allclose(float(have), float(dense), rtol=1e-10)
    want, have = _both("kinetic_energy", vel, mass)
    np.testing.assert_allclose(float(have), float(want), rtol=1e-12)


def test_f32_against_jax_and_oracle(dim):
    pos, _, mass = _bodies(300, dim, np.float32)
    oracle, _ = _both("brute_force_direct", pos.astype(np.float64),
                      mass.astype(np.float64))
    for name, kw in [("brute_force_direct", {}),
                     ("brute_force_blocked", {"block_size": 128})]:
        want, have = _both(name, pos, mass, **kw)
        assert have.dtype == torch.float32
        assert float(scale_normalized_error(have, np.asarray(want))) < 1e-5
        assert float(scale_normalized_error(have, np.asarray(oracle))) < 1e-5


def test_coincident_bodies_softening_zero():
    rng = np.random.default_rng(3)
    pos = np.concatenate([[[1.0, 1.0], [1.0, 1.0], [5.0, 1.0]],
                          rng.uniform(10, 20, size=(37, 2))])
    mass = np.ones(40)
    c = {"config": {"G": 1.0, "softening": 0.0}}
    for name, kw in [("brute_force_direct", {}),
                     ("brute_force_blocked", {"block_size": 16})]:
        want, have = _both(name, pos, mass, cfg=c, cfg_t=c, **kw)
        assert bool(torch.isfinite(have).all())
        np.testing.assert_allclose(have.numpy(), np.asarray(want),
                                   rtol=1e-12)
    # Bodies 0 and 1 feel each other not at all, and the same rest.
    np.testing.assert_allclose(have[0].numpy(), have[1].numpy())
