"""The port's body-sharded LET Barnes-Hut and FMM
(nbody_tpu_torch.parallel.let_tree) on CPU meshes of 4, against the JAX
package's let_tree on 4 of the virtual CPU devices of tests/conftest.py,
the port's single-device tiers and the direct sum.

Tolerances, f64: against the JAX package, rtol 1e-10 with atol 1e-10 of
the largest force (the same algorithm; only summation orders differ).
Against the port's single-device tier at the same leaf level and far
field, the JAX tests' own bounds (tests/test_let_tree.py: 1e-8 for
Barnes-Hut, 1e-7 for the FMM), held here with atol at that fraction of
the largest force. Against the direct sum, the JAX tests' gates. The
sizing helpers are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu as jnb
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.models import plummer_sphere as jplummer
from nbody_tpu.parallel import let_tree as jlet
from nbody_tpu.parallel import mesh as jmesh
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops import fmm as tfmm
from nbody_tpu_torch.ops import grid_tree as tgt
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.parallel import let_tree as tlet
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


def _jax(fn, pos, mass, cfg=None, **kw):
    return np.asarray(fn(jnp.asarray(pos), jnp.asarray(mass),
                         cfg or JGravity(),
                         mesh=jmesh.make_mesh(jax.devices()[:P]), **kw))


@pytest.mark.parametrize("dim", [2, 3])
def test_let_barnes_hut_matches_jax(dim):
    """N = 700, θ = 0.5 (k = 1), leaf level 3 (2D) / 2 (3D): the JAX
    defaults otherwise (quadrupole, local far field, exact H and halo)."""
    pos, mass = _bodies(700, dim, seed=dim)
    L = 3 if dim == 2 else 2
    got = tlet.let_barnes_hut(*_t(pos, mass), TGravity(), mesh=_mesh(),
                              theta=0.5, leaf_level=L)
    _close(got.numpy(), _jax(jlet.let_barnes_hut, pos, mass, theta=0.5,
                             leaf_level=L), 1e-10)


@pytest.mark.parametrize("dim", [2, 3])
def test_let_fmm_matches_jax(dim):
    pos, mass = _bodies(700, dim, seed=10 + dim)
    L = 3 if dim == 2 else 2
    got = tlet.let_fmm(*_t(pos, mass), TGravity(), mesh=_mesh(), order=4,
                       leaf_level=L)
    _close(got.numpy(), _jax(jlet.let_fmm, pos, mass, order=4, leaf_level=L),
           1e-10)


@pytest.mark.parametrize("tier,dim", [("bh", 2), ("bh", 3), ("fmm", 2),
                                      ("fmm", 3)])
def test_let_tiers_match_the_single_device_tiers(tier, dim):
    """The JAX tests' own cases on the port: the same leaf level on both
    sides, so the trees are the same."""
    pos, mass = _t(*_bodies(700, dim, seed=20 + dim))
    L = 3 if dim == 2 else 2
    if tier == "bh":
        got = tlet.let_barnes_hut(pos, mass, TGravity(), mesh=_mesh(),
                                  theta=0.5, leaf_level=L)
        want = tgt.barnes_hut_grid(pos, mass, TGravity(), theta=0.5,
                                   leaf_level=L, layout="dense")
        tol = 1e-8
    else:
        got = tlet.let_fmm(pos, mass, TGravity(), mesh=_mesh(), order=4,
                           leaf_level=L)
        want = tfmm.fmm_forces(pos, mass, TGravity(), order=4, leaf_level=L,
                               layout="dense")
        tol = 1e-7
    _close(got.numpy(), want.numpy(), tol)


@pytest.mark.parametrize("multipole,far_impl,theta",
                         [("mono", "point", 0.5), ("quad", "local", 0.25)])
def test_let_barnes_hut_far_field_options(multipole, far_impl, theta):
    """The other far fields the JAX tier takes: monopole per body (the
    reference's), and θ = 0.25 (k = 3: the ring's wider near field and
    halo) through the local expansion; held to the single-device tier
    with the same far field."""
    pos, mass = _t(*_bodies(900, 2, seed=30))
    kw = dict(theta=theta, leaf_level=4, multipole=multipole,
              far_impl=far_impl)
    got = tlet.let_barnes_hut(pos, mass, TGravity(), mesh=_mesh(), **kw)
    want = tgt.barnes_hut_grid(pos, mass, TGravity(), layout="dense", **kw)
    _close(got.numpy(), want.numpy(), 1e-10)


def test_let_barnes_hut_pads_a_ragged_n():
    """N = 333 is not a multiple of P·8: the padding rows (idx −1) are
    never shipped and never read back."""
    pos, mass = _t(*_bodies(333, 2, seed=40))
    got = tlet.let_barnes_hut(pos, mass, TGravity(), mesh=_mesh(), theta=0.5,
                              leaf_level=2)
    want = tgt.barnes_hut_grid(pos, mass, TGravity(), theta=0.5,
                               leaf_level=2, layout="dense")
    _close(got.numpy(), want.numpy(), 1e-8)


def test_let_fmm_order8_gate():
    """Order 8 at N = 1200 2D, leaf level 3: under 1e-4 against the direct
    sum (tests/test_let_tree.py::test_let_fmm_gate)."""
    pos, mass = _t(*_bodies(1200, 2, seed=50))
    got = tlet.let_fmm(pos, mass, TGravity(), mesh=_mesh(), order=8,
                       leaf_level=3)
    err = float(scale_normalized_error(
        got, brute_force_direct(pos, mass, TGravity())))
    assert 0.0 < err < 1e-4, err


def test_let_barnes_hut_plummer_default_knobs():
    """A Plummer core (600 bodies, θ = 0.25) with no hand-set knob: the
    bucket is the exact peak, the halo capacity the exact geometric one;
    under 1e-3 against the direct sum."""
    s, cfg = jplummer(jax.random.key(60), 600, dtype=jnp.float64)
    pos, mass = _t(s.positions, s.masses)
    tcfg = TGravity(G=cfg.G, softening=cfg.softening)
    got = tlet.let_barnes_hut(pos, mass, tcfg, mesh=_mesh(), theta=0.25)
    err = float(scale_normalized_error(got,
                                       brute_force_direct(pos, mass, tcfg)))
    assert err < 1e-3, err


@pytest.mark.parametrize("tier,knob", [("bh", {"halo_cap": 8}),
                                       ("fmm", {"halo_cap": 8}),
                                       ("bh", {"bucket_headroom": 0.5})])
def test_overflow_poisons_every_row(tier, knob):
    """A halo list or exchange bucket too small for the input poisons
    every row that comes back with NaN, on every shard: never a silent
    cut. A bucket overflow drops bodies, whose rows stay 0 (the JAX
    package's materialization too)."""
    pos, mass = _t(*_bodies(700, 2, seed=70))
    fn = tlet.let_barnes_hut if tier == "bh" else tlet.let_fmm
    kw = {"theta": 0.5} if tier == "bh" else {"order": 3}
    got = fn(pos, mass, TGravity(), mesh=_mesh(), leaf_level=3, **kw, **knob)
    nan_rows = torch.isnan(got).all(dim=1)
    if "halo_cap" in knob:
        assert bool(nan_rows.all())
    else:
        dropped = (got == 0).all(dim=1)
        assert bool((nan_rows | dropped).all()) and 0 < int(dropped.sum())
        assert int(nan_rows.sum()) > 350


@pytest.mark.parametrize("dim,L,p,k", [(2, 3, 4, 1), (2, 4, 8, 3),
                                       (3, 2, 4, 1), (3, 3, 8, 2),
                                       (2, 2, 16, 1)])
def test_halo_cap_exact_matches_jax(dim, L, p, k):
    cc = (1 << (dim * L)) // p
    assert tlet.halo_cap_exact(dim, L, cc, k) == jlet.halo_cap_exact(
        dim, L, cc, k)


@pytest.mark.parametrize("dim,L,p,n", [(2, 3, 4, 700), (3, 2, 4, 333),
                                       (2, 5, 8, 1000), (3, 3, 2, 512)])
def test_exchange_bucket_peak_matches_jax(dim, L, p, n):
    pos, _ = _bodies(n, dim, seed=80 + L)
    rows = -(-n // (p * 8)) * 8
    assert tlet.exchange_bucket_peak(torch.from_numpy(pos), L, p, rows) == \
        jlet._exchange_bucket_peak(jnp.asarray(pos), L, p, rows)


@pytest.mark.parametrize("fn", [tlet.let_barnes_hut, tlet.let_fmm])
def test_three_shards_are_refused(fn):
    """P = 3 divides no 2^(D·L): the JAX package drops the leaves past
    3·cc; the port raises."""
    pos, mass = _t(*_bodies(300, 2, seed=90))
    with pytest.raises(ValueError, match="power-of-two"):
        fn(pos, mass, TGravity(), mesh=_mesh(3))


def test_exchange_ships_every_body_once():
    """After the exchange each shard holds exactly its chunk's bodies: the
    valid rows of all shards are the input rows, each once, and every
    row's key lies in its shard's leaf range."""
    pos, mass = _t(*_bodies(500, 3, seed=95))
    mesh = _mesh()
    L, cc = 2, 64 // P
    sp, sm, si = tlet.shard_padded(mesh, pos, mass)
    H = tlet.bucket_rows(pos, L, P, 512, None)
    chunks = tlet._exchange(mesh, sp, sm, si, L=L, cc=cc, H=H, capacity=8)
    seen = torch.cat([c.idx[c.valid] for c in chunks])
    assert sorted(seen.tolist()) == list(range(500))
    for c in chunks:
        assert not bool(c.overflow)
        v = c.valid
        assert bool(((c.key[v] >= c.my0) & (c.key[v] < c.my0 + cc)).all())
        assert bool((c.key[~v] == P * cc).all())
        assert torch.equal(c.pos_sorted[v], pos[c.idx[v]])
