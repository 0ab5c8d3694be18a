"""The BVH walk, escalation driver and front ends (nbody_tpu_torch.ops.bvh,
Simulation("bvh"), registry tier h, CLI -m h) against nbody_tpu.ops.bvh
on the same numpy bodies.

Tolerances: the walk's stats (max frontier, max near count, per-group
overflow) equal the JAX package's exactly. In f64 both packages evaluate the
same nodes with the same operations and differ only in summation order, so
accelerations agree to 1e-12 (relative to the largest). Against the direct
sum, the JAX package's own bounds (tests/test_bvh.py, tests/test_clustered.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu as jnb
from nbody_tpu.bench import registry as jreg
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.ops import bvh as jb
from nbody_tpu.ops.brute_force import brute_force_direct as j_direct
from nbody_tpu.simulation import Simulation as JSimulation
from nbody_tpu.state import System as JSystem
from nbody_tpu_torch import cli
from nbody_tpu_torch.bench import registry
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.config import TreeConfig
from nbody_tpu_torch.ops import bvh as tb
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.ops.keys import MAX_BITS
from nbody_tpu_torch.simulation import Simulation
from nbody_tpu_torch.state import system_from_numpy
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)

UNIT = {"G": 1.0, "softening": 1e-4}


def _close(have, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(have), want, rtol=rtol,
                               atol=rtol * float(np.nanmax(np.abs(want))))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _bodies(n, dim, seed, dtype=jnp.float64):
    s = jnb.random_system(jax.random.key(seed), n, dim=dim, dtype=dtype)
    return np.asarray(s.positions), np.asarray(s.masses)


def _clustered(n, frac, dim=3, seed=0):
    """``frac`` of the bodies in a 1e-3-wide ball at 0.5, the rest in
    [0, 1]^D, unit masses (tests/test_clustered.py's clustered input)."""
    rng = np.random.default_rng(seed)
    nc = int(n * frac)
    pos = np.concatenate([0.5 + 1e-3 * rng.uniform(0, 1, (nc, dim)),
                          rng.uniform(0, 1, (n - nc, dim))])
    return pos, np.ones(n)


def _jtree(pos, mass, quad=True):
    dim = pos.shape[1]
    return jb.build_bvh(jnp.asarray(pos), jnp.asarray(mass),
                        dim * MAX_BITS[dim], quad=quad)


def _carry(jtree):
    """The JAX tree's fields, handed to the port as numpy arrays."""
    return tb.bvh_tree_from_numpy(
        {f.name: getattr(jtree, f.name) if f.name == "key_bits"
         else np.asarray(getattr(jtree, f.name))
         for f in dataclasses.fields(jtree)}, device="cpu")


@pytest.fixture(scope="module")
def trees():
    """JAX-built quad trees of 2000 bodies in 2D and 3D and their carried
    copies: small groups, so the gated local expansion takes real work."""
    out = {}
    for dim in (2, 3):
        jt = _jtree(*_bodies(2000, dim, seed=20 + dim))
        out[dim] = (jt, _carry(jt))
    return out


_WALK = dict(theta=0.5, softening=1e-6, group_size=8, batch=64,
             return_stats=True)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("multipole,far_impl", [
    ("mono", "point"), ("mono", "local"), ("quad", "point"),
    ("quad", "local")])
def test_walk_on_a_jax_tree_matches_jax(trees, dim, multipole, far_impl):
    jt, tt = trees[dim]
    kw = dict(_WALK, multipole=multipole, far_impl=far_impl)
    want = [np.asarray(x) for x in jb.bvh_accel_sorted(jt, **kw)]
    have = [x.numpy() for x in tb.bvh_accel_sorted(tt, **kw)]
    _close(have[0], want[0])
    assert [int(have[1]), int(have[2])] == [int(want[1]), int(want[2])]
    np.testing.assert_array_equal(have[3], want[3])
    assert not want[3].any()
    if far_impl == "local":
        # The gate takes real work here: "local" is not "point".
        point = tb.bvh_accel_sorted(tt, **dict(kw, far_impl="point"))[0]
        assert float(scale_normalized_error(have[0], point.numpy())) > 1e-9


def test_debug_skips_split_the_walk(trees):
    """The walk without its far field plus the walk without pass 2 is the
    whole walk (the phase split's ablations)."""
    _, tt = trees[2]
    kw = dict(theta=0.5, group_size=8, batch=64, multipole="quad")
    whole = tb.bvh_accel_sorted(tt, **kw)
    parts = tb.bvh_accel_sorted(tt, **kw, _debug_skip="far") \
        + tb.bvh_accel_sorted(tt, **kw, _debug_skip="near")
    _close(parts.numpy(), whole.numpy())
    assert float(tb.bvh_accel_sorted(tt, **kw, _debug_skip="far near")
                 .abs().max()) == 0.0


def test_walk_against_another_trees_source_matches_jax(trees):
    """``source``: the 3D tree's groups walk a second tree of the same
    key_bits (the cross-tree step of the JAX package's LET exchange)."""
    jt, tt = trees[3]
    other = _jtree(*_bodies(700, 3, seed=30))
    kw = dict(_WALK, multipole="quad")
    want = jb.bvh_accel_sorted(jt, **kw, source=(other.node_table,
                                                  other.body_table))
    oc = _carry(other)
    have = tb.bvh_accel_sorted(tt, **kw, source=(oc.node_table,
                                                  oc.body_table))
    _close(have[0].numpy(), want[0])
    assert [int(have[1]), int(have[2])] == [int(want[1]), int(want[2])]


@pytest.mark.parametrize("n,dim", [(5, 2), (5, 3), (11, 3)])
def test_fewer_bodies_than_a_leaf_match_jax_and_direct(n, dim):
    """N < leaf_size: pass 2's window start is negative (bvh.py:771), where
    a JAX gather wraps and clamps and torch would raise; the port clamps
    and masks. Both equal the direct sum."""
    pos, mass = _bodies(n, dim, seed=n)
    cfg = JGravity()
    want = np.asarray(jb.bvh_forces(jnp.asarray(pos), jnp.asarray(mass), cfg))
    have = tb.bvh_forces(*_t(pos, mass), TGravity()).numpy()
    _close(have, want)
    direct = brute_force_direct(*_t(pos, mass), TGravity()).numpy()
    _close(have, direct, rtol=1e-12)


def test_fp32_walk_against_the_f64_oracle():
    """tests/test_bvh.py:64-71's bound, on fp32 bodies."""
    pos, mass = _bodies(256, 3, seed=3, dtype=jnp.float32)
    got = tb.bvh_forces(*_t(pos, mass), TGravity(), theta=0.25, batch=128)
    assert got.dtype == torch.float32
    want = j_direct(jnp.asarray(pos, jnp.float64),
                    jnp.asarray(mass, jnp.float64), JGravity())
    assert float(scale_normalized_error(got.double(), np.asarray(want))) \
        < 5e-3


def test_group_ids_subset_matches_full_walk():
    """tests/test_bvh.py:166-185: the subset walk reproduces the full
    walk's rows bit for bit (per-group walks are independent), and both
    equal the JAX package's."""
    n, dim, G = 1024, 2, 64
    jt = _jtree(*_bodies(n, dim, seed=0))
    tt = _carry(jt)
    kw = dict(theta=0.25, softening=0.0, group_size=G, batch=8,
              frontier_width=512, near_cap=512, multipole="quad")
    full = tb.bvh_accel_sorted(tt, **kw).numpy()
    ids = [1, 7, 12]
    sub, maxw, ncnt, over = tb.bvh_accel_sorted(
        tt, **kw, group_ids=torch.tensor(ids), return_stats=True)
    assert sub.shape == (3 * G, dim) and not bool(over.any())
    rows = (np.asarray(ids)[:, None] * G + np.arange(G)).reshape(-1)
    np.testing.assert_array_equal(sub.numpy(), full[rows])
    jsub, jmaxw, jncnt, jover = jb.bvh_accel_sorted(
        jt, **kw, group_ids=jnp.asarray(ids, jnp.int32), return_stats=True)
    _close(sub.numpy(), jsub)
    assert [int(maxw), int(ncnt)] == [int(jmaxw), int(jncnt)]


def test_ragged_near_cap_no_double_count():
    """tests/test_bvh.py:187-213: a near cap that is not a multiple of the
    pass-2 chunk is rounded up to whole chunks; nothing is evaluated twice."""
    rng = np.random.default_rng(9)
    pos = np.concatenate([0.5 + 1e-3 * rng.uniform(0, 1, (448, 3)),
                          rng.uniform(0, 1, (64, 3))])
    mass = np.ones(512)
    jt = _jtree(pos, mass)
    tt = _carry(jt)
    kw = dict(theta=0.5, softening=1e-4, group_size=32, batch=64,
              frontier_width=1024, multipole="quad")
    ragged = tb.bvh_accel_sorted(tt, **kw, near_cap=130).numpy()
    generous = tb.bvh_accel_sorted(tt, **kw, near_cap=1024).numpy()
    assert np.isfinite(ragged).all()
    _close(ragged, generous)
    _close(ragged, jb.bvh_accel_sorted(jt, **kw, near_cap=130))


def test_overflow_poisons_the_same_groups_as_jax():
    """A near cap under the densest groups' counts poisons those groups
    (8 of 63 here) with NaN and leaves the others' rows exact."""
    pos, mass = _clustered(2000, 0.3)
    jt = _jtree(pos, mass)
    kw = dict(theta=0.5, softening=1e-4, group_size=32, batch=16,
              frontier_width=256, near_cap=100, multipole="quad",
              return_stats=True)
    want = [np.asarray(x) for x in jb.bvh_accel_sorted(jt, **kw)]
    have = [x.numpy() for x in tb.bvh_accel_sorted(_carry(jt), **kw)]
    assert want[3].any() and not want[3].all()
    np.testing.assert_array_equal(have[3], want[3])
    assert [int(have[1]), int(have[2])] == [int(want[1]), int(want[2])]
    nan_rows = np.isnan(have[0]).any(axis=1)
    np.testing.assert_array_equal(nan_rows, np.isnan(want[0]).any(axis=1))
    np.testing.assert_array_equal(
        nan_rows, np.repeat(want[3], 32)[:2000])
    _close(have[0][~nan_rows], want[0][~nan_rows])


@pytest.mark.parametrize("frac,caps", [(0.9, 16), (0.3, 48)])
def test_escalation_matches_jax(frac, caps):
    """tests/test_clustered.py:106-133 (marked slow there, so run here):
    tiny caps escalate to a finite answer equal to the JAX package's, to a
    generous single walk, and within the θ = 0.5 bound of the direct sum."""
    pos, mass = _clustered(2000, frac)
    kw = dict(theta=0.5, group_size=32, frontier_width=caps, near_cap=caps,
              max_escalations=8)
    want = np.asarray(jb.bvh_forces(jnp.asarray(pos), jnp.asarray(mass),
                                    JGravity(**UNIT), **kw))
    tb.HOST_READS["count"] = 0
    have = tb.bvh_forces(*_t(pos, mass), TGravity(**UNIT), **kw).numpy()
    assert np.isfinite(have).all()
    _close(have, want)
    generous = tb.bvh_forces(*_t(pos, mass), TGravity(**UNIT), theta=0.5,
                             group_size=32, frontier_width=4000,
                             near_cap=4000, max_escalations=0).numpy()
    assert float(scale_normalized_error(have, generous)) < 1e-12
    direct = brute_force_direct(*_t(pos, mass), TGravity(**UNIT)).numpy()
    assert float(scale_normalized_error(have, direct)) < 5e-2


def test_cap_bucket_grid():
    assert tb._cap_bucket(0) == 0 and tb._cap_bucket(-3) == 0
    assert tb._cap_bucket(1) == 2048 and tb._cap_bucket(2048) == 2048
    assert tb._cap_bucket(2049) == 4096
    for x in [1, 100, 2047, 2049, 5000, 20_000, 123_457, 1 << 20,
              (1 << 20) + 1, 9_999_999]:
        b = tb._cap_bucket(x)
        step = max(2048, 1 << max(x.bit_length() - 4, 0))
        # The smallest multiple of the step that holds x: 1/8 of the power
        # of two below x (at least 2048).
        assert b % step == 0 and x <= b < x + step
        assert b == jb._cap_bucket(x)


def test_caps_state_seeds_the_next_call():
    """The first unit test of ``caps_state``: after one escalated call the
    dict holds the JAX package's settled caps; a second call seeded from it
    gives the same forces."""
    pos, mass = _clustered(2000, 0.9, seed=3)
    kw = dict(theta=0.5, group_size=32, frontier_width=16, near_cap=16,
              max_escalations=8)
    jstate, tstate = {}, {}
    want = np.asarray(jb.bvh_forces(jnp.asarray(pos), jnp.asarray(mass),
                                    JGravity(**UNIT), caps_state=jstate,
                                    **kw))
    first = tb.bvh_forces(*_t(pos, mass), TGravity(**UNIT),
                          caps_state=tstate, **kw).numpy()
    assert tstate == jstate and set(tstate) == {"w2", "nl2"}
    assert all(v == tb._cap_bucket(v) and v > 0 for v in tstate.values())
    _close(first, want)
    tb.HOST_READS["count"] = 0
    second = tb.bvh_forces(*_t(pos, mass), TGravity(**UNIT),
                           caps_state=tstate, **kw).numpy()
    np.testing.assert_array_equal(second, first)
    assert tstate == jstate
    # Seeded: stats, the overflowed groups, then one re-walk that fits.
    assert tb.HOST_READS["count"] > 3
    # Uniform bodies under the default caps never escalate and leave the
    # dict untouched.
    state = {}
    tb.bvh_forces(*_t(*_bodies(300, 2, seed=1)), TGravity(),
                  caps_state=state)
    assert state == {}


@pytest.mark.parametrize("n", [1000, 5_000_000])
def test_far_impl_and_tier_h_hyperparams_match_jax(n):
    assert tb.resolve_bvh_far_impl(n) == jb.resolve_bvh_far_impl(n)
    for dim in (2, 3):
        for leaf in (8, 16):
            have = registry.get("BVH_Radix").hyperparams(
                n, dim, TGravity(), TreeConfig(max_bodies_per_leaf=leaf))
            want = jreg.get("BVH_Radix").hyperparams(
                n, dim, JGravity(),
                jnb.TreeConfig(max_bodies_per_leaf=leaf))
            assert have == want
    assert registry.PORTED_TIERS == "abhf"
    assert [m.name for m in registry.methods_for_tiers("h", "cpu")] == \
        ["BVH_Radix"]


def test_simulation_bvh_step_matches_jax():
    n, dim = 512, 3
    rng = np.random.default_rng(5)
    arrs = (rng.normal(size=(n, dim)), 0.2 * rng.normal(size=(n, dim)),
            np.full(n, 1.0 / n))
    jsys = JSystem(*(jnp.asarray(a, jnp.float64) for a in arrs))
    tsys = system_from_numpy(*arrs, device="cpu", dtype=torch.float64)
    cfg = {"G": 1.0, "softening": 0.05}
    want = JSimulation.create(jsys, JGravity(**cfg), method="bvh")\
        .run(steps=1, dt=1e-2)
    have = Simulation.create(tsys, TGravity(**cfg), method="bvh")\
        .run(steps=1, dt=1e-2)
    assert have.method == "bvh" and have.step_count == 1
    _close(have.system.positions.numpy(), want.system.positions)
    _close(have.system.velocities.numpy(), want.system.velocities)


def test_cli_tier_h_on_cpu(capsys):
    rc = cli.main(["-d", "2", "-N", "300", "-m", "h", "-a", "1",
                   "--device", "cpu", "--no-files", "--warmup", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "methods=['BVH_Radix']" in out
    assert "BVH_Radix accuracy:" in out


def test_sharded_walk_matches_jax(trees):
    """Three shards of the walk (bvh_accel_sorted(shard_index, num_shards):
    250 groups of 8 split 84 / 84 / 82) add up to the JAX package's walk
    of the same tree (the call of the quad/point case above, so its
    compiled program), and the shards' overflow flags concatenate to
    JAX's; 1e-12 in f64."""
    jt, tt = trees[2]
    kw = dict(_WALK, multipole="quad", far_impl="point")
    want = [np.asarray(x) for x in jb.bvh_accel_sorted(jt, **kw)]
    parts = [tb.bvh_accel_sorted(tt, shard_index=r, num_shards=3, **kw)
             for r in range(3)]
    _close(sum(p[0] for p in parts).numpy(), want[0])
    np.testing.assert_array_equal(
        np.concatenate([p[3].numpy() for p in parts]), want[3])
    assert max(int(p[1]) for p in parts) == int(want[1])
