"""The port's sharded tree tiers (nbody_tpu_torch.parallel.sharded_tree) and
the sharded evaluation inside ops/grid_tree.py, ops/fmm.py and ops/bvh.py,
on CPU meshes, against the port's unsharded tiers and the JAX package.

Tolerances, f64: against the port's unsharded tier on the same bodies,
1e-12 of the largest force (the same operations; the shards only split
which bodies a call evaluates, and the partials are added once). Against
the JAX package, 1e-10: its sharded Barnes-Hut (nbody_tpu.parallel.
sharded_tree on the virtual CPU devices of tests/conftest.py, ~3 s a call
on the CPU) in the case marked here. The sharded FMM and BVH calls are held
to the JAX package's unsharded tier (which its own tests/test_sharded_tree.py
holds equal to its sharded tier at 1e-10) in the files whose compiled JAX
programs they reuse, at 1e-12: tests/test_torch_fmm.py::
test_sharded_stages_match_jax_f64, tests/test_torch_bvh.py::
test_sharded_walk_matches_jax, and the grid tier's shards in
tests/test_torch_grid_tree.py::test_sharded_partials_match_jax. Each JAX
BVH or FMM compile costs 4-12 s under the test run's load.
Where a case needs more shards than the 8 virtual devices (the leaf-level
bump in 3D, M2L's coarse levels at P = 32, empty BVH shards), only the
port's unsharded tier is the reference; the JAX package's own
tests/test_sharded_tree.py holds its sharded tiers equal to its unsharded
ones at 1e-10. The dry run keeps the JAX package's gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu as jnb
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.parallel import mesh as jmesh
from nbody_tpu.parallel import sharded_tree as jst
from nbody_tpu_torch.bench import registry
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops import bvh as tbvh
from nbody_tpu_torch.ops import fmm as tfmm
from nbody_tpu_torch.ops import grid_tree as tgt
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.ops.keys import MAX_BITS
from nbody_tpu_torch.parallel import dryrun
from nbody_tpu_torch.parallel import mesh as tmesh
from nbody_tpu_torch.parallel import sharded_tree as tst
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

torch.set_num_threads(2)

CFG = {"G": 1.0, "softening": 1e-3}


def _close(have, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(have), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _bodies(n, dim, seed):
    s = jnb.random_system(jax.random.key(seed), n, dim=dim,
                          dtype=jnp.float64)
    pos, mass = np.array(s.positions), np.array(s.masses)
    return pos / 1e7, mass / 1e8  # unit-sized cube and masses


def _t(pos, mass):
    return torch.from_numpy(pos), torch.from_numpy(mass)


def _cpu_mesh(p):
    return tmesh.make_mesh([torch.device("cpu")] * p)


def _jax(fn, pos, mass, p, **kw):
    return np.asarray(fn(jnp.asarray(pos), jnp.asarray(mass),
                         JGravity(**CFG), mesh=jmesh.make_mesh(
                             jax.devices()[:p]), **kw))


# --- Barnes-Hut ----------------------------------------------------------

@pytest.mark.parametrize("dim,p,jax_too", [(2, 2, False), (2, 4, False),
                                           (3, 2, False), (3, 4, True)])
def test_barnes_hut_sharded_matches_unsharded(dim, p, jax_too):
    """θ = 0.5 (k = 1), the JAX defaults (quadrupole, per-body far field),
    at leaf level 3 (2D) / 2 (3D), where the far field is engaged; JAX's
    barnes_hut_sharded where marked."""
    pos, mass = _bodies(1000 if dim == 2 else 800, dim, seed=dim + p)
    tp, tm = _t(pos, mass)
    level = 3 if dim == 2 else 2
    got = tst.barnes_hut_sharded(tp, tm, TGravity(**CFG), mesh=_cpu_mesh(p),
                                 theta=0.5, leaf_level=level)
    want = tgt.barnes_hut_grid(tp, tm, TGravity(**CFG), theta=0.5,
                               leaf_level=level, far_impl="point",
                               layout="dense")
    _close(got.numpy(), want.numpy(), 1e-12)
    err = float(scale_normalized_error(got, brute_force_direct(
        tp, tm, TGravity(**CFG))))
    assert 1e-5 < err < 4e-2  # the far field is engaged
    if jax_too:
        _close(got.numpy(), _jax(jst.barnes_hut_sharded, pos, mass, p,
                                 theta=0.5, leaf_level=level), 1e-10)


def test_grid_segments_nest_inside_shards():
    """``num_segments`` splits each shard's leaves further, as in the JAX
    package: the 4 × 2 (shard, segment) calls each own rows of their
    shard only, and add up to the unsharded call (1e-12)."""
    pos, mass = _bodies(1200, 2, seed=7)
    tp, tm = _t(pos, mass)
    tree = tgt.build_grid_tree(tp, tm, 3, tgt.compute_capacity(tp, 3),
                               quad=True)
    kw = dict(k=1, multipole="quad", softening=1e-3)
    whole = tgt.grid_tree_accel_sorted(tree, **kw)
    total = torch.zeros_like(whole)
    for r in range(4):
        shard = tgt.grid_tree_accel_sorted(tree, shard_index=r, num_shards=4,
                                           **kw)
        segs = [tgt.grid_tree_accel_sorted(
            tree, shard_index=r, num_shards=4, num_segments=2,
            segment_index=si, **kw) for si in range(2)]
        inside = shard.abs().sum(-1) > 0
        for seg in segs:
            assert not bool((seg.abs().sum(-1) > 0)[~inside].any())
        _close((segs[0] + segs[1]).numpy(), shard.numpy(), 1e-12)
        total += shard
    _close(total.numpy(), whole.numpy(), 1e-12)


@pytest.mark.parametrize("dim,p", [(2, 8), (3, 16)])
def test_barnes_hut_sharded_small_tree_bumps_the_leaf_level(dim, p):
    """N = 40: the auto leaf level (1) has fewer leaves than shards, so
    it rises until each shard owns one (2D: 16 leaves at P = 8; 3D: 64 at
    P = 16); held to the port's unsharded tier at leaf level 2."""
    pos, mass = _bodies(40, dim, seed=11)
    tp, tm = _t(pos, mass)
    assert tgt.auto_leaf_level(40, dim) == 1
    got = tst.barnes_hut_sharded(tp, tm, TGravity(**CFG), mesh=_cpu_mesh(p),
                                 theta=0.5)
    want = tgt.barnes_hut_grid(tp, tm, TGravity(**CFG), theta=0.5,
                               leaf_level=2, far_impl="point",
                               layout="dense")
    _close(got.numpy(), want.numpy(), 1e-12)


# --- FMM -----------------------------------------------------------------

@pytest.mark.parametrize("dim,p", [(2, 2), (2, 4), (3, 2), (3, 4)])
def test_fmm_sharded_matches_unsharded(dim, p):
    """Order 4 at leaf level 3 (2D) / 2 (3D): P2M chunks and M2L rows at
    every level sharded and gathered."""
    pos, mass = _bodies(1000 if dim == 2 else 800, dim, seed=20 + dim + p)
    tp, tm = _t(pos, mass)
    level = 3 if dim == 2 else 2
    got = tst.fmm_sharded(tp, tm, TGravity(**CFG), mesh=_cpu_mesh(p),
                          order=4, leaf_level=level)
    want = tfmm.fmm_forces(tp, tm, TGravity(**CFG), order=4,
                           leaf_level=level, layout="dense")
    _close(got.numpy(), want.numpy(), 1e-12)


def test_fmm_sharded_coarse_levels_run_once():
    """P = 32 in 2D at leaf level 3: level 2's 16 cells are fewer than the
    shards, so that level runs whole on each device; level 3's 64 rows
    are sharded."""
    pos, mass = _bodies(2000, 2, seed=25)
    tp, tm = _t(pos, mass)
    got = tst.fmm_sharded(tp, tm, TGravity(**CFG), mesh=_cpu_mesh(32),
                          order=4, leaf_level=3)
    want = tfmm.fmm_forces(tp, tm, TGravity(**CFG), order=4, leaf_level=3,
                           layout="dense")
    _close(got.numpy(), want.numpy(), 1e-12)


# --- BVH -----------------------------------------------------------------

@pytest.mark.parametrize("dim,p", [(2, 2), (2, 3), (3, 4), (3, 40)])
def test_bvh_sharded_matches_unsharded(dim, p):
    """Groups of 64 (16 / 13 groups): P = 3 splits them unevenly, P = 40
    leaves shards without a group (their partials are zero)."""
    pos, mass = _bodies(1000 if dim == 2 else 800, dim, seed=30 + dim + p)
    tp, tm = _t(pos, mass)
    got = tst.bvh_sharded(tp, tm, TGravity(**CFG), mesh=_cpu_mesh(p),
                          theta=0.5, group_size=64)
    want = tbvh.bvh_forces(tp, tm, TGravity(**CFG), theta=0.5,
                           group_size=64, far_impl="point")
    _close(got.numpy(), want.numpy(), 1e-12)


# --- The sharded calls themselves ----------------------------------------

@pytest.mark.parametrize("tier", ["grid", "fmm", "bvh"])
def test_shard_partials_add_up_and_stay_in_their_rows(tier):
    """Each shard's partial is zero outside its own sorted bodies, and the
    partials add up to the unsharded call."""
    pos, mass = _bodies(1200, 2, seed=40)
    tp, tm = _t(pos, mass)
    p = 4
    if tier == "bvh":
        tree = tbvh.build_bvh(tp, tm, 2 * MAX_BITS[2], quad=True)
        kw = dict(theta=0.5, group_size=64, multipole="quad")
        call = tbvh.bvh_accel_sorted
    else:
        tree = tgt.build_grid_tree(tp, tm, 3, tgt.compute_capacity(tp, 3),
                                   quad=True)
        if tier == "grid":
            kw, call = dict(k=1, multipole="quad"), tgt.grid_tree_accel_sorted
        else:
            kw, call = dict(order=4), tfmm.fmm_accel_sorted
    whole = call(tree, **kw)
    parts = [call(tree, shard_index=r, num_shards=p, **kw) for r in range(p)]
    _close(sum(parts).numpy(), whole.numpy(), 1e-12)
    owners = (torch.stack([x.abs().sum(-1) > 0 for x in parts])).sum(0)
    assert int(owners.max()) == 1  # no row is in two shards' partials


def test_sharding_refusals():
    pos, mass = _t(*_bodies(300, 2, seed=50))
    tree = tgt.build_grid_tree(pos, mass, 2, tgt.compute_capacity(pos, 2))
    with pytest.raises(ValueError, match="single-device"):
        tfmm.fmm_accel_sorted(tree, shard_index=0, num_shards=2,
                              num_chunks=8)
    with pytest.raises(ValueError, match="evenly"):
        tgt.grid_tree_accel_sorted(tree, shard_index=0, num_shards=3)
    with pytest.raises(ValueError, match="evenly"):
        tst.barnes_hut_sharded(pos, mass, mesh=_cpu_mesh(3), theta=0.5)
    btree = tbvh.build_bvh(pos, mass, 2 * MAX_BITS[2])
    with pytest.raises(ValueError, match="group_ids"):
        tbvh.bvh_accel_sorted(btree, group_ids=torch.tensor([0]),
                              shard_index=0, num_shards=2)
    with pytest.raises(ValueError, match="shard_index"):
        tbvh.bvh_accel_sorted(btree, num_shards=2)


# --- Registry and dry run --------------------------------------------------

MULTI = {"BruteForce_Ring", "BarnesHut_Sharded", "FMM_Sharded",
         "BVH_Sharded"}


@pytest.mark.parametrize("count,listed", [(0, False), (1, False),
                                          (4, True)])
def test_registry_lists_multi_device_methods_only_on_a_mesh(
        monkeypatch, count, listed):
    """Listed where the default mesh (every visible CUDA device) has more
    than one shard, for CUDA runs (the mesh is CUDA's)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    names = {m.name for m in registry.methods_for_tiers("abhf", "cuda")}
    assert (MULTI <= names) == listed and (MULTI & names == set()) != listed
    cpu = {m.name for m in registry.methods_for_tiers("abhf", "cpu")}
    assert not MULTI & cpu
    tiers = {registry.get(n).tier for n in MULTI}
    assert tiers == set("abfh")
    assert all(registry.get(n).multi_device_only for n in MULTI)


def test_dryrun_multichip_on_a_cpu_mesh_of_4():
    """One ring leapfrog step at N = 64, then each tier at N = 2048 3D
    fp32 against the direct sum, with the JAX package's gates; the tree
    tiers' errors are nonzero (dryrun raises otherwise). The three
    body-sharded LET rows are among them, with the JAX package's gates
    (BH 1.3e-2, FMM 5e-4, BVH 1e-3)."""
    errors = dryrun.dryrun_multichip(_cpu_mesh(4), log=lambda *_: None)
    assert len(errors) == 7
    for (name, _, gate, nonzero) in dryrun.TIERS:
        assert errors[name] < gate and (errors[name] > 0 or not nonzero)
    let = {name: gate for name, _, gate, _ in dryrun.TIERS
           if name.startswith("LET")}
    assert let == {"LET BH (body-sharded)": 1.3e-2,
                   "LET FMM (body-sharded)": 5e-4,
                   "LET BVH (body-sharded)": 1e-3}
    assert all(0 < errors[name] < gate for name, gate in let.items())
