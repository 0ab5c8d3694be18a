"""The port's body-sharded LET BVH (nbody_tpu_torch.parallel.let_bvh) on
CPU meshes of 4, against the JAX package's let_bvh on 4 of the virtual CPU
devices of tests/conftest.py and the direct sum.

Tolerances, f64: against the JAX package, rtol 1e-10 with atol 1e-10 of
the largest force (the same per-shard trees and walks). Against the direct
sum, the JAX tests' own bounds (tests/test_let_bvh.py): 1e-7 at θ = 0,
where every node is opened, and 1e-3 at θ = 0.25. The per-shard trees
differ from the single-device tree, so the single-device tier is no
reference here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu as jnb
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.models import plummer_sphere as jplummer
from nbody_tpu.parallel.let_bvh import let_bvh as jlet_bvh
from nbody_tpu.parallel import mesh as jmesh
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.parallel.let_bvh import let_bvh
from nbody_tpu_torch.parallel import mesh as tmesh
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

torch.set_num_threads(2)

P = 4


def _close(have, want, rtol):
    want = np.asarray(want)
    have = np.asarray(have)
    assert np.all(np.isfinite(have))
    np.testing.assert_allclose(have, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _bodies(n, dim, seed):
    s = jnb.random_system(jax.random.key(seed), n, dim=dim,
                          dtype=jnp.float64)
    return np.array(s.positions), np.array(s.masses)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _mesh(p=P):
    return tmesh.make_mesh([torch.device("cpu")] * p)


def _direct(pos, mass, cfg=None):
    return brute_force_direct(pos, mass, cfg or TGravity())


@pytest.mark.parametrize("dim", [2, 3])
def test_let_bvh_matches_jax(dim):
    """N = 700, θ = 0.25, the JAX defaults (groups of 1024 capped at a
    shard's rows, quadrupole, exact bucket peak)."""
    pos, mass = _bodies(700, dim, seed=dim)
    got = let_bvh(*_t(pos, mass), TGravity(), mesh=_mesh(), theta=0.25)
    want = np.asarray(jlet_bvh(
        jnp.asarray(pos), jnp.asarray(mass), JGravity(),
        mesh=jmesh.make_mesh(jax.devices()[:P]), theta=0.25))
    _close(got.numpy(), want, 1e-10)


@pytest.mark.parametrize("dim,n", [(2, 700), (3, 700), (2, 333)])
def test_let_bvh_theta0_is_the_direct_sum(dim, n):
    """θ = 0 opens every node: the direct sum to 1e-7; N = 333 pads the
    shards (idx −1 rows moved onto the last valid body, mass 0)."""
    pos, mass = _t(*_bodies(n, dim, seed=10 + dim))
    got = let_bvh(pos, mass, TGravity(), mesh=_mesh(), theta=0.0,
                  frontier_width=2048, near_cap=2048)
    _close(got.numpy(), _direct(pos, mass).numpy(), 1e-7)


def test_let_bvh_plummer_default_knobs():
    """A Plummer core (600 bodies, θ = 0.25) with no hand-set knob: under
    1e-3 against the direct sum."""
    s, cfg = jplummer(jax.random.key(20), 600, dtype=jnp.float64)
    pos, mass = _t(s.positions, s.masses)
    tcfg = TGravity(G=cfg.G, softening=cfg.softening)
    got = let_bvh(pos, mass, tcfg, mesh=_mesh(), theta=0.25)
    assert bool(torch.isfinite(got).all())
    err = float(scale_normalized_error(got, _direct(pos, mass, tcfg)))
    assert err < 1e-3, err


def test_let_bvh_near_cap_overflow_poisons():
    """A near capacity of 8 overflows: the walk poisons its groups with
    NaN, never truncates."""
    pos, mass = _t(*_bodies(700, 2, seed=30))
    got = let_bvh(pos, mass, TGravity(), mesh=_mesh(), theta=0.0,
                  near_cap=8, frontier_width=2048)
    assert not bool(torch.isfinite(got).all())


def test_let_bvh_bucket_overflow_poisons():
    """A Plummer input with bucket_headroom 1.0 overflows the exchange
    buckets: every row that comes back is NaN, the dropped bodies' rows
    stay 0."""
    s, cfg = jplummer(jax.random.key(40), 600, dtype=jnp.float64)
    pos, mass = _t(s.positions, s.masses)
    got = let_bvh(pos, mass, TGravity(G=cfg.G, softening=cfg.softening),
                  mesh=_mesh(), theta=0.25, bucket_headroom=1.0)
    nan_rows = torch.isnan(got).all(dim=1)
    dropped = (got == 0).all(dim=1)
    assert bool((nan_rows | dropped).all()) and int(nan_rows.sum()) > 0


def test_let_bvh_refuses_three_shards():
    """The JAX package's search for the exchange level never ends at
    P = 3 (it is not run here); the port raises."""
    pos, mass = _t(*_bodies(300, 2, seed=50))
    with pytest.raises(ValueError, match="power-of-two"):
        let_bvh(pos, mass, TGravity(), mesh=_mesh(3))
