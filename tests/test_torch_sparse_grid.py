"""The sparse grid (nbody_tpu_torch.ops.sparse_grid, the chunked build of
grid_tree, and barnes_hut_grid's layout dispatch) against
nbody_tpu.ops.sparse_grid on the same numpy bodies, on clustered inputs
that the dense grid refuses.

Tolerances: integer tables equal; in f64 both packages run the same
operations and differ only in summation order (the chunk sums are added
into the cells by index_add_ here, a scatter-add there), so aggregates,
near fields and evaluations agree to 1e-12 (relative, or scale-normalized
for accelerations). Against the direct sum, the JAX package's own bounds
(tests/test_sparse_grid.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.ops import grid_tree as jg
from nbody_tpu.ops import sparse_grid as js
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops import grid_tree as tg
from nbody_tpu_torch.ops import sparse_grid as ts
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)

UNIT = {"G": 1.0, "softening": 1e-4}


def _clustered(n, dim, seed, frac=0.6, at=0.5):
    """``frac`` of the bodies in a 1e-3-wide ball at ``at``, the rest in
    [0, 1]^D (tests/test_sparse_grid.py's clustered input)."""
    rng = np.random.default_rng(seed)
    nc = int(n * frac)
    pos = np.concatenate([at + 1e-3 * rng.uniform(0, 1, (nc, dim)),
                          rng.uniform(0, 1, (n - nc, dim))])
    return pos, rng.uniform(0.5, 1.5, n)


def _err(have, want):
    return float(scale_normalized_error(have, np.asarray(want)))


def _close(have, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(have), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _carry(jtree):
    fields = {f.name: getattr(jtree, f.name)
              for f in dataclasses.fields(jtree)}
    return tg.grid_tree_from_numpy(
        {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
             else v if isinstance(v, int) else np.asarray(v))
         for k, v in fields.items()}, device="cpu")


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


_COUNTS = [
    # tests/test_sparse_grid.py's example, three rows over the true total.
    (np.array([0, 5, 0, 130, 64, 1, 0, 3]), 64, 3),
    (np.random.default_rng(4).integers(0, 40, 300) * (
        np.random.default_rng(5).uniform(size=300) < 0.7), 8, 0),
]


@pytest.mark.parametrize("counts,chunk,extra", _COUNTS)
def test_chunk_table_matches_jax(counts, chunk, extra):
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    nt = int(np.sum(-(-counts // chunk))) + extra
    want = jax.jit(jg.chunk_table, static_argnames=("chunk", "num_chunks"))(
        jnp.asarray(starts, jnp.int32), jnp.asarray(counts, jnp.int32),
        chunk=chunk, num_chunks=nt)
    have = tg.chunk_table(*_t(starts, counts), chunk=chunk, num_chunks=nt)
    for h, w in zip(have, want):
        assert h.dtype == torch.int64
        np.testing.assert_array_equal(h.numpy(), np.asarray(w))
    assert int(have[2][nt - extra:].sum()) == 0


@functools.lru_cache(maxsize=None)
def _sparse_case(dim, k=1, chunk=64, window=8, n=4000):
    """(JAX sparse tree, port tree carried from it, port tree built by the
    port, num_chunks, max_windows) for clustered bodies."""
    pos, mass = _clustered(n, dim, seed=dim)
    level = tg.auto_leaf_level(n, dim, k=k)
    nt, nw = js.sparse_grid_stats(jnp.asarray(pos), level, chunk, window, k)
    jtree = jg.build_grid_tree(jnp.asarray(pos), jnp.asarray(mass), level, 8,
                               quad=True, agg_num_chunks=nt,
                               agg_chunk_size=chunk)
    ttree = tg.build_grid_tree(*_t(pos, mass), level, 8, quad=True,
                               agg_num_chunks=nt, agg_chunk_size=chunk)
    return jtree, _carry(jtree), ttree, nt, nw


@pytest.mark.parametrize("dim,k,chunk,window", [(2, 1, 64, 8),
                                                (3, 1, 64, 8),
                                                (2, 3, 512, 8),
                                                (3, 2, 16, 4)])
def test_sparse_grid_stats_match_jax(dim, k, chunk, window):
    pos, _ = _clustered(3000, dim, seed=11)
    level = tg.auto_leaf_level(3000, dim, k=k)
    want = js.sparse_grid_stats(jnp.asarray(pos), level, chunk, window, k)
    assert ts.sparse_grid_stats(torch.from_numpy(pos), level, chunk, window,
                                k) == want


@pytest.mark.parametrize("dim", [2, 3])
def test_chunked_build_matches_jax_and_the_dense_build(dim):
    jtree, _, ttree, _, _ = _sparse_case(dim)
    for name in ("order", "leaf_ids", "cell_start", "cell_count",
                 "window_slot"):
        np.testing.assert_array_equal(getattr(ttree, name).numpy(),
                                      np.asarray(getattr(jtree, name)))
    for name in ("level_mass", "level_com", "level_pack", "level_quad"):
        for h, w in zip(getattr(ttree, name), getattr(jtree, name)):
            _close(h, w)
    # The chunk sums equal the capacity-padded windows' sums.
    pos, mass = _t(*_clustered(4000, dim, seed=dim))
    dense = tg.build_grid_tree(pos, mass, ttree.leaf_level,
                               tg.compute_capacity(pos, ttree.leaf_level),
                               quad=True)
    for name in ("level_mass", "level_com", "level_quad"):
        for h, w in zip(getattr(ttree, name), getattr(dense, name)):
            _close(h, w)


@pytest.mark.parametrize("dim", [2, 3])
def test_near_field_windows_matches_jax(dim):
    """Two batches of chunks: the dense core's (its ring holds more than one
    sub-batch of windows) and the last, far from the core, whose later
    sub-batches are empty and skipped."""
    jtree, tree, _, nt, nw = _sparse_case(dim)
    cell, cstart, clen, _ = tg.chunk_table(
        tree.cell_start, tree.cell_count, chunk=64, num_chunks=nt)
    assert -(-nw // 256) >= 2
    core = int(torch.argmax(tree.cell_count[cell]))
    bt = tree.body_pack.reshape(-1, 4)
    fn = jax.jit(js.near_field_windows, static_argnames=(
        "k", "window", "max_windows", "softening"))
    kw = dict(k=1, window=8, max_windows=nw, softening=1e-4)
    for rows in (slice(max(0, core - 8), core + 8), slice(nt - 16, nt)):
        idx = (cstart[rows, None] + torch.arange(64)).clamp(0, len(bt) - 1)
        tpos = bt[idx][..., :dim]
        want = fn(jtree, jnp.asarray(cell[rows].numpy(), jnp.int32),
                  jnp.asarray(tpos.numpy()), **kw)
        have = ts.near_field_windows(tree, cell[rows], tpos, **kw)
        valid = (torch.arange(64) < clen[rows, None]).numpy()
        assert _err(have.numpy()[valid], np.asarray(want)[valid]) < 1e-12
        # Skipping the slots past each row block's longest chunk changes
        # no real target.
        trimmed = ts.near_field_windows(tree, cell[rows], tpos,
                                        tlen=clen[rows], **kw)
        _close(trimmed.numpy()[valid], have.numpy()[valid])


# The default chunks (512 bodies) in 2D; 64-body chunks elsewhere keep the
# [chunks, chunk, 2048] near-field tiles small on the CPU.
@pytest.mark.parametrize("dim,theta,kw", [
    (2, 0.5, {}), (3, 0.5, {"chunk_size": 64}),
    (2, 0.25, {"chunk_size": 64, "chunk_batch": 32})])
def test_barnes_hut_sparse_matches_jax(dim, theta, kw):
    pos, mass = _clustered(3000, dim, seed=20 + dim)
    want = js.barnes_hut_sparse(jnp.asarray(pos), jnp.asarray(mass),
                                JGravity(**UNIT), theta=theta, **kw)
    have = ts.barnes_hut_sparse(*_t(pos, mass), TGravity(**UNIT),
                                theta=theta, **kw)
    assert have.dtype == torch.float64 and have.shape == pos.shape
    assert _err(have, want) < 1e-12


def test_barnes_hut_sparse_segments_change_nothing():
    """Chunk batches padded to whole segments give the same bits."""
    pos, mass = _t(*_clustered(2000, 2, seed=30))
    kw = dict(theta=0.5, chunk_size=64, chunk_batch=4)
    one = ts.barnes_hut_sparse(pos, mass, TGravity(**UNIT), num_segments=1,
                               **kw)
    for segs in (3, 4):
        assert torch.equal(ts.barnes_hut_sparse(
            pos, mass, TGravity(**UNIT), num_segments=segs, **kw), one)


@pytest.mark.parametrize("dim", [2, 3])
def test_sparse_matches_dense_uniform(dim):
    """Same tree, same V-lists: the sparse layout reproduces the dense one
    on a quasi-uniform input."""
    rng = np.random.default_rng(40 + dim)
    args = _t(rng.uniform(0, 1, (3000, dim)), rng.uniform(0.5, 1.5, 3000))
    cfg = TGravity(G=1.0, softening=1e-6)
    dense = tg.barnes_hut_grid(*args, cfg, theta=0.5, layout="dense")
    sparse = tg.barnes_hut_grid(*args, cfg, theta=0.5, layout="sparse")
    assert _err(sparse, dense) < 1e-12


# tests/test_sparse_grid.py's bounds; θ = 0.25 in 2D, where its ring of
# 7^D cells costs the CPU 14× less than in 3D.
@pytest.mark.parametrize("dim,theta,tol", [(3, 0.5, 3e-2), (2, 0.25, 4e-3)])
def test_sparse_clustered_vs_direct(dim, theta, tol):
    """The input class the dense grid refuses, against the direct sum."""
    pos, mass = _t(*_clustered(2000, dim, seed=50))
    cfg = TGravity(**UNIT)
    got = ts.barnes_hut_sparse(pos, mass, cfg, theta=theta, chunk_size=64)
    assert bool(torch.isfinite(got).all())
    assert _err(got, brute_force_direct(pos, mass, cfg)) < tol


def test_auto_layout_falls_back_to_sparse(monkeypatch):
    """Past the capacity guard "dense" refuses, "auto" takes the sparse
    path with the resolved leaf level, and "hier" runs as "local"."""
    pos, mass = _t(*_clustered(5000, 3, seed=60, frac=0.85, at=0.3))
    cfg = TGravity(**UNIT)
    level = tg.auto_leaf_level(5000, 3, k=3)
    assert tg.compute_capacity(pos, level) > tg.CLUSTERED_CAPACITY_LIMIT
    with pytest.raises(ValueError, match="too clustered"):
        tg.barnes_hut_grid(pos, mass, cfg, theta=0.25, layout="dense")
    calls = []
    monkeypatch.setattr(ts, "barnes_hut_sparse",
                        lambda *a, **k: calls.append(k) or "sparse")
    for layout in ("auto", "sparse"):
        assert tg.barnes_hut_grid(pos, mass, cfg, theta=0.25,
                                  layout=layout) == "sparse"
    assert calls == 2 * [{"theta": 0.25, "leaf_level": level,
                          "multipole": "quad", "far_impl": "local"}]
