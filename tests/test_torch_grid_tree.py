"""The grid tree of the Barnes-Hut tier (nbody_tpu_torch.ops.grid_tree)
against nbody_tpu.ops.grid_tree: the build field by field, the static
tables, the far field in every mode and the whole sorted evaluation, on one
tree carried into the port by ``grid_tree_from_numpy``.

Tolerances: integer fields equal; f64 aggregates and f64 evaluations to
1e-12 (relative, or scale-normalized for accelerations): both packages run
the same operations, so only summation order separates them.
"""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import grid_tree as jg
from nbody_tpu.ops.hier_far import hier_far_coeffs as jax_hier
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops import grid_tree as tg
from nbody_tpu_torch.ops.hier_far import hier_far_coeffs
from nbody_tpu_torch.utils import cuda_build
from nbody_tpu_torch.utils.accuracy import scale_normalized_error


# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)

_INT_FIELDS = ("order", "leaf_ids", "cell_start", "cell_count", "window_slot")
_FLOAT_FIELDS = ("lo", "cell_sizes", "pos_sorted", "mass_sorted",
                 "body_pack", "level_mass", "level_com", "level_pack",
                 "level_quad")


def _bodies(n, dim, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.0, 1e7, (n, dim)).astype(dtype),
            rng.uniform(1.0, 1e8, n).astype(dtype))


@functools.lru_cache(maxsize=None)
def _trees(n, dim, level, quad, seed=0):
    """(JAX tree, port tree built by the port, port tree carried from JAX)
    for one draw."""
    pos, mass = _bodies(n, dim, seed)
    cap = jg.compute_capacity(jnp.asarray(pos), level)
    jtree = jg.build_grid_tree(jnp.asarray(pos), jnp.asarray(mass), level,
                               cap, quad=quad)
    ttree = tg.build_grid_tree(torch.from_numpy(pos), torch.from_numpy(mass),
                               level, cap, quad=quad)
    fields = {f.name: getattr(jtree, f.name)
              for f in dataclasses.fields(jtree)}
    carried = tg.grid_tree_from_numpy(
        {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
             else v if isinstance(v, int) else np.asarray(v))
         for k, v in fields.items()}, device="cpu")
    return jtree, ttree, carried


def _close(have, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(have), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-300))


def _acc_err(have, want):
    return float(scale_normalized_error(have, np.asarray(want)))


@pytest.mark.parametrize("dim", [2, 3])
def test_cell_coords_match_jax(dim):
    bits = 5 if dim == 2 else 4
    ids = np.arange(1 << (dim * bits), dtype=np.uint32)
    want = np.asarray(jg.cell_coords(jnp.asarray(ids), dim))
    have = tg.cell_coords(torch.from_numpy(ids.astype(np.int64)), dim)
    np.testing.assert_array_equal(have.numpy(), want)


def test_static_tables_match_jax():
    for dim in (2, 3):
        for k in (1, 2, 3):
            a, ka = jg._ring_offsets(dim, k)
            b, kb = tg._ring_offsets(dim, k)
            np.testing.assert_array_equal(a, b)
            assert ka == kb
            np.testing.assert_array_equal(jg._neighbor_offsets(dim, k),
                                          tg._neighbor_offsets(dim, k))
            for x, y in zip(jg._parent_window(dim, k),
                            tg._parent_window(dim, k)):
                np.testing.assert_array_equal(x, y)
            for c_gate in range(k, k + 4):
                for x, y in zip(jg._leaf_shell_subset(dim, k, c_gate),
                                tg._leaf_shell_subset(dim, k, c_gate)):
                    np.testing.assert_array_equal(x, y)
        assert tg._quad_pairs(dim) == jg._quad_pairs(dim)
    for n in (16, 1000, 100_000, 1_000_000, 5_000_000):
        for dim in (2, 3):
            for theta in (1.0, 0.5, 0.25, 0.125):
                assert tg.resolve_bh_params(n, dim, theta) == \
                    jg.resolve_bh_params(n, dim, theta)
            for k in (1, 3):
                assert tg.auto_leaf_level(n, dim, k=k) == \
                    jg.auto_leaf_level(n, dim, k=k)
    assert tg.resolve_bh_params(3_000_000, 3, 0.25, leaf_level=5,
                                leaf_batch=1024, multipole="mono") == \
        jg.resolve_bh_params(3_000_000, 3, 0.25, leaf_level=5,
                             leaf_batch=1024, multipole="mono")
    for theta in (0.05, 0.125, 0.25, 0.3, 0.5, 1.0, 2.0):
        assert tg.theta_to_ring(theta) == jg.theta_to_ring(theta)
    for cap, n, lvl, dim in ((600, 4000, 4, 2), (5000, 1e6, 6, 3),
                             (64, 1e5, 4, 3), (520, 1e5, 6, 2)):
        assert tg.dense_layout_degenerate(cap, n, lvl, dim) == \
            jg.dense_layout_degenerate(cap, n, lvl, dim)


@pytest.mark.parametrize("n,dim,level,quad", [(700, 2, 3, True),
                                              (900, 3, 2, True),
                                              (500, 2, 2, False)])
def test_build_matches_jax(n, dim, level, quad):
    jtree, ttree, carried = _trees(n, dim, level, quad)
    assert (ttree.dim, ttree.leaf_level, ttree.capacity) == \
        (jtree.dim, jtree.leaf_level, jtree.capacity)
    for name in _INT_FIELDS:
        np.testing.assert_array_equal(getattr(ttree, name).numpy(),
                                      np.asarray(getattr(jtree, name)),
                                      err_msg=name)
    for name in _FLOAT_FIELDS:
        have, want = getattr(ttree, name), getattr(jtree, name)
        if isinstance(want, tuple):
            assert len(have) == len(want), name
            for h, w in zip(have, want):
                _close(h.numpy(), w)
        else:
            _close(have.numpy(), want)
    # The carried tree holds JAX's values in the port's types.
    assert carried.order.dtype == torch.int64
    np.testing.assert_array_equal(carried.body_pack.numpy(),
                                  np.asarray(jtree.body_pack))


def test_build_f32_keys_and_capacity_match_jax():
    """fp32 positions: the same bounds, keys and leaf runs as JAX."""
    pos, mass = _bodies(3000, 3, seed=4, dtype=np.float32)
    for level in (2, 3):
        cap = jg.compute_capacity(jnp.asarray(pos), level)
        assert tg.compute_capacity(torch.from_numpy(pos), level) == cap
        jtree = jg.build_grid_tree(jnp.asarray(pos), jnp.asarray(mass),
                                   level, cap)
        ttree = tg.build_grid_tree(torch.from_numpy(pos),
                                   torch.from_numpy(mass), level, cap)
        for name in _INT_FIELDS:
            np.testing.assert_array_equal(getattr(ttree, name).numpy(),
                                          np.asarray(getattr(jtree, name)))
        np.testing.assert_array_equal(ttree.lo.numpy(), np.asarray(jtree.lo))


# 2D k = 1 in every mode; 3D k = 3 (2744 candidates a level) in the two
# modes that bracket it, since each 3D case costs seconds of JAX dispatch.
@pytest.mark.parametrize("dim,level,k,far_impl,multipole", [
    (2, 4, 1, f, m) for f in ("point", "local", "local_leaf")
    for m in ("mono", "quad")] + [(3, 3, 3, "point", "mono"),
                                  (3, 3, 3, "local_leaf", "quad")])
def test_far_field_rings_matches_jax(dim, level, k, far_impl, multipole):
    jtree, _, tree = _trees(1500 if dim == 2 else 1200, dim, level, True)
    ids = np.arange(0, tree.num_leaf_cells, 3)[:24].astype(np.int32)
    tb, _, _ = tg._window_rows(tree, torch.from_numpy(ids.astype(np.int64)))
    tpos = tb[..., :dim]
    want = jg.far_field_rings(jtree, jnp.asarray(ids),
                              jnp.asarray(tpos.numpy()), k=k,
                              multipole=multipole, far_impl=far_impl)
    have = tg.far_field_rings(tree, torch.from_numpy(ids.astype(np.int64)),
                              tpos, k=k, multipole=multipole,
                              far_impl=far_impl)
    assert float(np.abs(np.asarray(want)).max()) > 0
    assert _acc_err(have.reshape(-1, dim),
                    np.asarray(want).reshape(-1, dim)) < 1e-12


# (dim, level, k, far_impl, multipole, leaf_batch, segments, hier gather).
# 2D k = 2 keeps inner far shells per body (k < shell < c_min = 4), so it
# runs hier's pack consumer at a fraction of 3D's compile time; 3D k = 3
# runs the large-N 3D composition (gather, 4 segments).
_ACCEL_CASES = [
    (2, 4, 1, "local", "quad", 64, 1, False),    # k = 1 neighbour layout
    (2, 4, 3, "point", "mono", 64, 2, False),    # parent-shared, segments
    (2, 4, 3, "local_leaf", "quad", 512, 1, False),
    (2, 4, 2, "hier", "quad", 64, 1, False),     # hier, pack mode
    (3, 3, 3, "hier", "quad", 128, 4, True),     # hier, gather, segments
]


@pytest.mark.parametrize("case", _ACCEL_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_accel_sorted_matches_jax(case):
    dim, level, k, far_impl, multipole, lb, segs, gather = case
    jtree, _, tree = _trees(1500 if dim == 2 else 1200, dim, level, True)
    kw = dict(k=k, softening=1e-6, leaf_batch=lb, multipole=multipole,
              far_impl=far_impl)
    jkw, tkw = dict(kw), dict(kw)
    if gather:
        jkw["hier_coeffs"] = jax_hier(jtree, k, multipole=multipole,
                                      defer="gather")[0]
        tkw["hier_coeffs"] = hier_far_coeffs(tree, k, multipole=multipole,
                                             defer="gather")[0]
    want = sum(np.asarray(jg.grid_tree_accel_sorted(
        jtree, num_segments=segs, segment_index=jnp.int32(si), **jkw))
        for si in range(segs))
    have = sum(tg.grid_tree_accel_sorted(tree, num_segments=segs,
                                         segment_index=si, **tkw)
               for si in range(segs))
    assert have.shape == (tree.n, dim)
    assert _acc_err(have, want) < 1e-12
    whole = tg.grid_tree_accel_sorted(tree, **tkw)
    assert _acc_err(have, whole.numpy()) < 1e-13


def test_debug_skip_splits_near_and_far():
    """_debug_skip="near" / "far" evaluate one part each; they add up to
    the whole evaluation, as in the JAX package (tools/bh_near_probe.py)."""
    jtree, _, tree = _trees(1500, 2, 4, True)
    kw = dict(k=3, softening=1e-6, multipole="quad", far_impl="hier")
    parts = [tg.grid_tree_accel_sorted(tree, _debug_skip=s, **kw)
             for s in ("far", "near")]
    whole = tg.grid_tree_accel_sorted(tree, **kw)
    assert _acc_err(parts[0] + parts[1], whole.numpy()) < 1e-13
    want = np.asarray(jg.grid_tree_accel_sorted(jtree, _debug_skip="far",
                                                **kw))
    assert _acc_err(parts[0], want) < 1e-12


@pytest.mark.parametrize("k,dim,level,lb", [(1, 2, 4, 64), (3, 2, 4, 64),
                                            (3, 3, 3, 512), (2, 3, 2, 4)])
def test_near_launches_counts_the_near_field_calls(monkeypatch, k, dim,
                                                   level, lb):
    """The near field is one call per evaluation of a segment (one K6
    launch on CUDA tensors, the count the chip run holds the path to), over
    the segment's whole leaf range whatever the leaf batches; the segments'
    parts add up to the whole near field."""
    _, _, tree = _trees(1500 if dim == 2 else 1200, dim, level, True)
    calls = []
    real = tg._near_field_accel

    def counting(*args):
        calls.append(args[4:6])  # (leaf0, nleaves)
        return real(*args)

    monkeypatch.setattr(tg, "_near_field_accel", counting)
    half = tree.num_leaf_cells // 2
    parts = [tg.grid_tree_accel_sorted(tree, k=k, leaf_batch=lb,
                                       num_segments=2, segment_index=si,
                                       _debug_skip="far") for si in (0, 1)]
    assert calls == [(0, half), (half, half)]
    whole = tg.grid_tree_accel_sorted(tree, k=k, leaf_batch=lb,
                                      _debug_skip="far")
    assert calls[2:] == [(0, tree.num_leaf_cells)]
    assert _acc_err(parts[0] + parts[1], whole.numpy()) < 1e-13


def test_unported_layouts_and_p2p_impl_raise():
    """The sparse layout, the chunked build and "auto" on a degenerate
    input now run (held to the JAX package here; the sparse grid's own
    tests are tests/test_torch_sparse_grid.py); a bad layout or p2p_impl
    still raises."""
    pos, mass = _bodies(4000, 2, seed=1)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    want = jg.barnes_hut_grid(jnp.asarray(pos), jnp.asarray(mass),
                              theta=0.5, layout="sparse")
    assert _acc_err(tg.barnes_hut_grid(tp, tm, theta=0.5, layout="sparse"),
                    want) < 1e-12
    nt = sum(-(-c // 64) for c in tg.build_grid_tree(
        tp, tm, 2, 512).cell_count.tolist())
    chunked = tg.build_grid_tree(tp, tm, 2, 64, agg_num_chunks=nt)
    dense = tg.build_grid_tree(tp, tm, 2, 512)
    for h, w in zip(chunked.level_pack, dense.level_pack):
        _close(h, w)
    # 60% of the bodies in one small cell (the JAX package's own example of
    # a degenerate dense layout, grid_tree.py:226-230): "auto" takes the
    # sparse path, as the JAX package's does.
    clustered = tp.clone()
    clustered[:2400] = 5e6 + torch.from_numpy(
        np.random.default_rng(2).uniform(0, 1, (2400, 2)))
    cap = jg.compute_capacity(jnp.asarray(clustered.numpy()), 4)
    assert jg.dense_layout_degenerate(cap, 4000, 4, 2)
    assert tg.dense_layout_degenerate(cap, 4000, 4, 2)
    want = jg.barnes_hut_grid(jnp.asarray(clustered.numpy()),
                              jnp.asarray(mass), theta=0.5, leaf_level=4)
    assert _acc_err(tg.barnes_hut_grid(clustered, tm, theta=0.5,
                                       leaf_level=4), want) < 1e-12
    with pytest.raises(ValueError, match="layout"):
        tg.barnes_hut_grid(tp, tm, layout="tiled")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tg.barnes_hut_grid(tp, tm, p2p_impl="cuda")
    with pytest.raises(ValueError, match="p2p_impl"):
        tg.barnes_hut_grid(tp, tm, p2p_impl="pallas")
    # "auto" on this f64 tree takes the plain near field: no launch, the
    # plain near field's values.
    assert tg._resolve_p2p_impl("auto", torch.device("cpu")) == "auto"
    assert tg._resolve_p2p_impl("auto", torch.device("cuda")) == "auto"
    assert tg._resolve_p2p_impl("plain", torch.device("cuda")) == "plain"
    before = dict(cuda_build.LAUNCHES)
    auto = tg.barnes_hut_grid(tp, tm, p2p_impl="auto")
    assert cuda_build.LAUNCHES == before
    assert torch.equal(auto, tg.barnes_hut_grid(tp, tm, p2p_impl="plain"))


@pytest.mark.parametrize("p2p_impl,dtype,route", [
    ("auto", torch.float64, "plain"), ("auto", torch.float32, "K6"),
    ("cuda", torch.float64, "K6")])
def test_near_field_route_follows_the_trees_dtype(monkeypatch, p2p_impl,
                                                  dtype, route):
    """"auto" takes K6's wrapper only for an fp32 tree; any other tree gets
    the plain near field in its own dtype, as the JAX package's "auto" (its
    jnp path) does. An explicit "cuda" is K6, which computes in fp32, on any
    dtype."""
    from nbody_tpu_torch.ops import cuda_p2p
    calls = []

    def recorder(name):
        def near_field(tree, k, softening, leaf0, nleaves, leaf_batch):
            calls.append((name, k, softening, leaf0, nleaves, leaf_batch))
            return name
        return near_field

    monkeypatch.setattr(cuda_p2p, "near_field_cuda", recorder("K6"))
    monkeypatch.setattr(cuda_p2p, "near_field_plain", recorder("plain"))
    tree = types.SimpleNamespace(pos_sorted=torch.zeros((8, 3), dtype=dtype))
    assert tg._near_field_accel(tree, 2, 0.5, p2p_impl, 4, 16, 64) == route
    assert calls == [(route, 2, 0.5, 4, 16, 64)]


def test_barnes_hut_grid_is_build_evaluate_unsort_scale():
    """barnes_hut_grid = build, evaluate, unsort, scale by G·m (the JAX
    package's _bh_grid_fused body)."""
    pos, mass = _bodies(1000, 2, seed=3)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    cfg = TGravity()
    rp = tg.resolve_bh_params(1000, 2, cfg.theta)
    cap = tg.compute_capacity(tp, rp["leaf_level"])
    tree = tg.build_grid_tree(tp, tm, rp["leaf_level"], cap, quad=True)
    acc = tg.grid_tree_accel_sorted(tree, k=rp["k"], softening=cfg.softening,
                                    multipole="quad",
                                    far_impl=rp["far_impl"])
    manual = torch.zeros_like(acc)
    manual[tree.order] = acc
    manual = (cfg.G * tm)[:, None] * manual
    assert torch.equal(tg.barnes_hut_grid(tp, tm, cfg), manual)
    assert torch.equal(tg.barnes_hut_grid(tp, tm, cfg, capacity=cap,
                                          layout="dense"), manual)


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_partials_match_jax(p):
    """Shard r's call (shard_index=r, num_shards=P: leaves [r·L/P,
    (r+1)·L/P), zero rows elsewhere) on the hier case of _ACCEL_CASES, the
    sweep made once and handed to every shard; the partials add up to the
    JAX package's unsharded call with the same arguments (its compiled
    program, cached by the case above), 1e-12."""
    dim, level, k, far_impl, multipole, lb, _, _ = next(
        c for c in _ACCEL_CASES if c[3] == "hier" and c[6] == 1)
    jtree, _, tree = _trees(1500, dim, level, True)
    kw = dict(k=k, softening=1e-6, leaf_batch=lb, multipole=multipole,
              far_impl=far_impl)
    want = np.asarray(jg.grid_tree_accel_sorted(
        jtree, num_segments=1, segment_index=jnp.int32(0), **kw))
    # One sweep for every shard, as parallel/sharded_tree.py hands it out.
    sweep = hier_far_coeffs(tree, k, multipole=multipole, defer="gather")[0]
    parts = [tg.grid_tree_accel_sorted(tree, shard_index=r, num_shards=p,
                                       hier_coeffs=sweep, **kw)
             for r in range(p)]
    assert _acc_err(sum(parts), want) < 1e-12
    owners = torch.stack([x.abs().sum(-1) > 0 for x in parts]).sum(0)
    assert int(owners.max()) == 1
