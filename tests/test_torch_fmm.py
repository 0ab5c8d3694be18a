"""The black-box FMM tier (nbody_tpu_torch.ops.fmm, Simulation("fmm"),
registry tier f) against nbody_tpu.ops.fmm, on the same numpy bodies and,
phase by phase, on one tree carried into the port by
``grid_tree_from_numpy``.

Tolerances: the Chebyshev tables and V-list offsets are the same numpy code
and equal exactly; in f64 both packages run the same operations and differ
only in summation order, so P2M weights, each level's M2L output and whole
evaluations agree to 1e-12 (relative, or scale-normalized for
accelerations); in fp32 each side rounds its own sums: 1e-5. Against the
direct sum, the JAX package's own gates (tests/test_fmm.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.bench import registry as jreg
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.config import TreeConfig as JTree
from nbody_tpu.ops import fmm as JF
from nbody_tpu.ops import grid_tree as jg
from nbody_tpu.simulation import Simulation as JSimulation
from nbody_tpu.state import System as JSystem
from nbody_tpu_torch import cli
from nbody_tpu_torch.bench import registry
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.config import TreeConfig
from nbody_tpu_torch.ops import fmm as TF
from nbody_tpu_torch.ops import grid_tree as tg
from nbody_tpu_torch.ops import sparse_grid as ts
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.simulation import Simulation
from nbody_tpu_torch.state import system_from_numpy
from nbody_tpu_torch.utils import profiling
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)

SOFT = 1e-6


def _bodies(n, dim, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.0, 1e7, (n, dim)).astype(dtype),
            rng.uniform(1.0, 1e8, n).astype(dtype))


def _err(have, want):
    return float(scale_normalized_error(have, np.asarray(want)))


def _close(have, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(have), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _carry(jtree):
    """The JAX tree as a port tree (same fields, int64 indices)."""
    fields = {f.name: getattr(jtree, f.name)
              for f in dataclasses.fields(jtree)}
    return tg.grid_tree_from_numpy(
        {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
             else v if isinstance(v, int) else np.asarray(v))
         for k, v in fields.items()}, device="cpu")


def _jax_phases(jtree, order):
    """The JAX package's FMM on ``jtree`` in f64 with its P2M weights and
    every level's M2L output: one jit of ``fmm_accel_sorted``'s body with
    ``lax.map`` / ``lax.scan`` recorded while it traces (the first map is
    P2M; the scans are M2L's, one per level 2..L)."""
    rec = {"map": [], "scan": []}
    real_map, real_scan = jax.lax.map, jax.lax.scan

    def map_(f, xs, **kw):
        out = real_map(f, xs, **kw)
        rec["map"].append(out)
        return out

    def scan_(f, init, xs=None, **kw):
        out = real_scan(f, init, xs, **kw)
        rec["scan"].append(out[0])
        return out

    def body(tree):
        rec["map"].clear()
        rec["scan"].clear()
        jax.lax.map, jax.lax.scan = map_, scan_
        try:
            acc = JF.fmm_accel_sorted.__wrapped__(tree, order=order,
                                                  softening=SOFT)
        finally:
            jax.lax.map, jax.lax.scan = real_map, real_scan
        return acc, rec["map"][0], list(rec["scan"])

    acc, p2m, m2l = jax.jit(body)(jtree)
    return (np.asarray(acc), np.asarray(p2m).reshape(-1, order ** jtree.dim),
            [np.asarray(x) for x in m2l])


# (dim, order) → (N, leaf level): M2M and L2L run from leaf level 3; 3D
# order 8 stays at level 2, where K alone is 316 × 512² f64 (662 MB).
_CASES = {(2, 4): (2000, 3), (2, 8): (2000, 3), (3, 4): (3000, 3),
          (3, 8): (1200, 2)}


@functools.lru_cache(maxsize=None)
def _case(dim, order):
    n, level = _CASES[(dim, order)]
    pos, mass = _bodies(n, dim, seed=10 * dim + order)
    cap = jg.compute_capacity(jnp.asarray(pos), level)
    jtree = jg.build_grid_tree(jnp.asarray(pos), jnp.asarray(mass), level,
                               cap)
    return _carry(jtree), _jax_phases(jtree, order)


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_chebyshev_tables_equal_jax(n):
    y = np.linspace(-1.2, 1.2, 23)
    np.testing.assert_array_equal(TF.cheb_nodes(n), JF.cheb_nodes(n))
    np.testing.assert_array_equal(TF._cheb_T(n, y), JF._cheb_T(n, y))
    np.testing.assert_array_equal(TF.s_matrix(n, y), JF.s_matrix(n, y))
    for dim in (2, 3):
        np.testing.assert_array_equal(TF._tensor_nodes(dim, n),
                                      JF._tensor_nodes(dim, n))
        np.testing.assert_array_equal(TF.m2m_operators(dim, n),
                                      JF.m2m_operators(dim, n))


@pytest.mark.parametrize("dim,k", [(2, 1), (3, 1), (2, 2), (3, 2)])
def test_v_list_deltas_equal_jax(dim, k):
    have, want = TF._v_list_deltas(dim, k), JF._v_list_deltas(dim, k)
    assert len(have) == len(want)
    for (dh, ph), (dw, pw) in zip(have, want):
        np.testing.assert_array_equal(dh, dw)
        np.testing.assert_array_equal(ph, pw)
    if k == 1:
        assert len(have) == {2: 40, 3: 316}[dim]


def test_cheb_recurrences_match_jax():
    y = np.linspace(-0.97, 0.97, 41).reshape(41, 1) * np.ones((1, 3))
    for n in (2, 5, 8):
        Tt = JF._cheb_T(n, JF.cheb_nodes(n)).T
        for have, want in zip(TF._cheb_T_and_dT(n, torch.from_numpy(y)),
                              JF._jnp_cheb_T_and_dT(n, jnp.asarray(y))):
            _close(have, want)
        _close(TF._interp_1d(n, torch.from_numpy(y), torch.from_numpy(Tt)),
               JF._interp_1d(n, jnp.asarray(y), jnp.asarray(Tt)))
        for have, want in zip(
                TF._interp_and_grad_1d(n, torch.from_numpy(y),
                                       torch.from_numpy(Tt)),
                JF._interp_and_grad_1d(n, jnp.asarray(y), jnp.asarray(Tt))):
            _close(have, want)


def _tables(tree, order):
    return TF._tables(tree.dim, order, torch.float64, "cpu")


@pytest.mark.parametrize("dim,order", sorted(_CASES))
def test_p2m_weights_match_jax(dim, order):
    tree, (_, p2m, _) = _case(dim, order)
    Tt, _ = _tables(tree, order)
    _close(TF._p2m_dense(tree, order, 1024, Tt), p2m)
    # Batches that do not divide the leaves give the same weights.
    _close(TF._p2m_dense(tree, order, 24, Tt), p2m)


@pytest.mark.parametrize("dim,order", sorted(_CASES))
def test_m2l_levels_match_jax(dim, order):
    tree, (_, _, m2l) = _case(dim, order)
    Tt, m2m = _tables(tree, order)
    W = TF._m2m(TF._p2m_dense(tree, order, 1024, Tt), m2m, dim,
                tree.leaf_level)
    Lc = TF._m2l(tree, W, order, 1)
    assert sorted(Lc) == list(range(2, tree.leaf_level + 1))
    assert len(m2l) == len(Lc)
    for l, want in zip(range(2, tree.leaf_level + 1), m2l):
        _close(Lc[l], want)


@pytest.mark.parametrize("dim,order", sorted(_CASES))
def test_fmm_accel_sorted_matches_jax_f64(dim, order):
    tree, (acc, _, _) = _case(dim, order)
    have = TF.fmm_accel_sorted(tree, order=order, softening=SOFT)
    assert have.dtype == torch.float64 and have.shape == acc.shape
    assert _err(have, acc) < 1e-12


def test_m2l_chunks_of_offsets_sum_alike(monkeypatch):
    """M2L over chunks of offsets (the gather budget) equals one chunk."""
    tree, (_, _, m2l) = _case(2, 8)
    Tt, m2m = _tables(tree, 8)
    W = TF._m2m(TF._p2m_dense(tree, 8, 1024, Tt), m2m, 2, tree.leaf_level)
    whole = TF._m2l(tree, W, 8, 1)
    # 3 offsets a chunk at the leaf level (64 cells × 64 nodes × 8 B each).
    monkeypatch.setattr(TF, "_M2L_GATHER_BYTES", 3 * 64 * 64 * 8)
    parts = TF._m2l(tree, W, 8, 1)
    for l in whole:
        _close(parts[l], whole[l], rtol=1e-13)
        _close(parts[l], m2l[l - 2])


def _masked_m2l_level(tree, w_l, order, l, row0=0, nrows=None):
    """The JAX package's masked M2L of rows [row0, row0 + nrows) at ring 1:
    every offset of the ring for every cell, the products that a cell's
    parity excludes or that leave the grid multiplied by zero."""
    dim, L = tree.dim, tree.leaf_level
    deltas = TF._v_list_deltas(dim, 1)
    dl = torch.as_tensor(np.stack([d for d, _ in deltas])).long()
    par_ok = torch.as_tensor(np.stack([p for _, p in deltas]))
    nodes = torch.as_tensor(TF._tensor_nodes(dim, order))
    KT = TF._m2l_kernel_t(tree, dl.double(), nodes)
    ncells = (1 << (dim * l)) - row0 if nrows is None else nrows
    xy = tg.cell_coords(torch.arange(row0, row0 + ncells), dim)
    src = xy[:, None, :] + dl[None]
    ok = tg._in_bounds(src, l)
    for d in range(dim):
        ok &= par_ok[:, d, :].T[xy[:, d] & 1]
    g = w_l.double()[tg._clipped_ids(src, l, dim, (ncells, -1))]
    return (g * ok[..., None]).reshape(ncells, -1) @ KT * 2.0 ** -(L - l)


def _upward(dim, order):
    tree, _ = _case(dim, order)
    Tt, m2m = _tables(tree, order)
    return tree, TF._m2m(TF._p2m_dense(tree, order, 1024, Tt), m2m, dim,
                         tree.leaf_level)


@pytest.mark.parametrize("dim,order", sorted(_CASES))
def test_m2l_by_class_equals_masked_sum(dim, order):
    """Each parity class's own offsets give the masked sum over every
    offset, to 1e-12 of the largest local weight, at every level: over the
    whole level, an aligned row range and unaligned ones (2D, P = 8 shards
    at level 2: rows [2r, 2r + 2))."""
    tree, W = _upward(dim, order)
    ops = TF._m2l_operators(tree, order, 1)
    for l in range(2, tree.leaf_level + 1):
        want = _masked_m2l_level(tree, W[l], order, l)
        tol = 1e-12 * float(want.abs().max())
        ncells, ncls = want.shape[0], 1 << dim
        ranges = [(0, None), (ncells // 4, ncells // 4),  # aligned
                  (ncls + 1, 2 * ncls + 3), (ncells - 3, 3)]
        if dim == 2 and l == 2:
            ranges += [(2 * r, 2) for r in range(8)]
        for row0, nrows in ranges:
            have = TF._m2l_level(tree, W[l], ops, l, row0, nrows)
            sl = slice(row0, None if nrows is None else row0 + nrows)
            assert have.shape == want[sl].shape
            assert float((have - want[sl]).abs().max()) <= tol, (l, row0)


@pytest.mark.parametrize("dim", [2, 3])
def test_m2l_counts_its_products_and_class_tables(dim):
    """Each class's table holds exactly the ring's offsets whose parity
    masks admit it, 27 (2D) or 189 (3D) of 40 or 316, and the classes
    together hold them all; with spans on, ``fmm.m2l_products`` counts
    Σ_l cells_l × that; with spans off, nothing is counted and the weights
    are the same bits."""
    deltas = TF._v_list_deltas(dim, 1)
    _, cls_dl, cls_rows, _ = TF._v_list_tables(dim, 1, 4,
                                                torch.device("cpu"))
    nc = {2: 27, 3: 189}[dim]
    assert tuple(cls_rows.shape) == (1 << dim, nc)
    for q in range(1 << dim):
        parity = tg.cell_coords(torch.tensor([q]), dim)[0].tolist()
        admits = [j for j, (_, ok) in enumerate(deltas)
                  if all(ok[d, parity[d]] for d in range(dim))]
        assert cls_rows[q].tolist() == admits
        np.testing.assert_array_equal(
            cls_dl[q].numpy(), np.stack([deltas[j][0] for j in admits]))
    assert sorted(set(cls_rows.flatten().tolist())) == list(
        range(len(deltas)))

    tree, W = _upward(dim, 4)
    profiling.reset_spans()
    try:
        profiling.enable_spans()
        on = TF._m2l(tree, W, 4, 1)
        assert profiling.counter_totals() == {"fmm.m2l_products": sum(
            (1 << (dim * l)) * nc for l in range(2, tree.leaf_level + 1))}
        profiling.reset_spans()
        off = TF._m2l(tree, W, 4, 1)
        assert profiling.counter_totals() == {}
        assert profiling.span_totals() == {}
    finally:
        profiling.reset_spans()
    assert sorted(on) == sorted(off)
    for l in on:
        assert torch.equal(on[l], off[l])


def test_p2m_and_l2p_batches_sum_alike(monkeypatch):
    """Dense P2M by batches of leaves (``_P2M_ELEMS``) and L2P by blocks of
    bodies (``_L2P_BLOCK``) equal one batch and one block, on every body
    and on one shard's bodies."""
    tree, _ = _case(3, 4)
    kw = dict(order=4, softening=SOFT)
    assert TF._p2m_batch(tree, 4) >= tree.num_leaf_cells
    whole = TF.fmm_accel_sorted(tree, **kw)
    shard = TF.fmm_accel_sorted(tree, shard_index=2, num_shards=4, **kw)
    monkeypatch.setattr(TF, "_L2P_BLOCK", 97)
    monkeypatch.setattr(TF, "_P2M_ELEMS", 5 * (tree.capacity // 8 + 1)
                        * 8 * 4 ** 3)
    assert TF._p2m_batch(tree, 4) == 5
    _close(TF.fmm_accel_sorted(tree, **kw), whole, rtol=1e-13)
    _close(TF.fmm_accel_sorted(tree, shard_index=2, num_shards=4, **kw),
           shard, rtol=1e-13)


@pytest.mark.parametrize("dim,n", [(2, 2000), (3, 1200)])
def test_fmm_forces_matches_jax_f64(dim, n):
    pos, mass = _bodies(n, dim, seed=3 + dim)
    want = JF.fmm_forces(jnp.asarray(pos), jnp.asarray(mass), JGravity(),
                         order=8)
    have = TF.fmm_forces(torch.from_numpy(pos), torch.from_numpy(mass),
                         TGravity(), order=8)
    assert have.dtype == torch.float64 and have.shape == (n, dim)
    assert _err(have, want) < 1e-12


def test_fmm_forces_matches_jax_f32():
    """fp32 on both sides with the plain near field; each side rounds its
    own matmul and pair sums."""
    pos, mass = _bodies(2000, 2, seed=8, dtype=np.float32)
    want = JF.fmm_forces(jnp.asarray(pos), jnp.asarray(mass), JGravity(),
                         order=6, leaf_level=3)
    have = TF.fmm_forces(torch.from_numpy(pos), torch.from_numpy(mass),
                         TGravity(), order=6, leaf_level=3, p2p_impl="plain")
    assert have.dtype == torch.float32
    assert _err(have, want) < 1e-5


def _direct(pos, mass, cfg):
    return brute_force_direct(torch.from_numpy(pos), torch.from_numpy(mass),
                              cfg)


def _tree_f64(tree):
    """The same tree with every float field in float64."""
    def f64(v):
        if isinstance(v, tuple):
            return tuple(f64(x) for x in v)
        return v.double() if torch.is_tensor(v) and v.is_floating_point() \
            else v
    return dataclasses.replace(tree, **{
        f.name: f64(getattr(tree, f.name)) for f in dataclasses.fields(tree)})


@pytest.mark.parametrize("dim,order,n,level", [(3, 8, 2000, 2),
                                               (2, 6, 4000, 3)])
def test_fp32_far_field_matches_f64_far_field(dim, order, n, level):
    """The fp32 tree's far field (P2M and M2M in fp32, the local side in
    float64) against the f64 tree's, over the RMS force of the f64 FMM.
    With an fp32 local side (the JAX package's arithmetic) these read
    3.6e-5 to 5.3e-5 and 8.9e-7 to 1.1e-6, by the CPU's thread count:
    L2P's cancellation. With the float64 local side 8.2e-8 and 2.9e-9,
    the multipole side's fp32 rounding."""
    pos, mass = (torch.from_numpy(a) for a in _bodies(n, dim, seed=40 + dim,
                                                      dtype=np.float32))
    tree = tg.build_grid_tree(pos, mass, level,
                              tg.compute_capacity(pos, level))
    t64 = _tree_f64(tree)
    kw = dict(order=order, softening=SOFT)
    far32 = TF.fmm_accel_sorted(tree, _debug_skip="p2p", **kw)
    assert far32.dtype == torch.float32
    far64 = TF.fmm_accel_sorted(t64, _debug_skip="p2p", **kw)
    full64 = far64 + TF.fmm_accel_sorted(t64, _debug_skip="m2l,l2p", **kw)
    rms = float(full64.norm(dim=-1).pow(2).mean().sqrt())
    assert float((far32.double() - far64).norm(dim=-1).max()) / rms < 3e-7


@pytest.mark.parametrize("layout", ["dense", "sparse", "adaptive"])
def test_simulation_fmm_fp32_within_1e4_of_direct_sum(layout):
    """Simulation("fmm") on fp32 bodies, one leapfrog step, its forces
    against the f64 direct sum at the stepped positions: within 1e-4, the
    deployment's bound. Uniform 2D bodies in reference units take the
    dense layout (leaf level 3); 60% of 3000 3D bodies in one small ball
    trip the dense guard: the sparse layout, asked for by name (its
    ``fmm_forces`` in the simulation's place), serves them at leaf level
    2. The occupied-cell layout, which ``layout="auto"`` takes there, is
    held on 60% of 6000 2D bodies in the ball, where the guard trips too
    (the 3D ball takes it to the keys' last level, over a minute on the
    CPU at order 8)."""
    if layout == "dense":
        pos, mass = _bodies(4096, 2, seed=50, dtype=np.float32)
        cfg = TGravity()
    else:
        pos, mass = (a.astype(np.float32) for a in (
            _clustered(3000, 3, seed=51) if layout == "sparse"
            else _clustered(6000, 2, seed=51)))
        cfg = TGravity(G=1.0, softening=1e-4)
    n, dim = pos.shape
    probes = []
    probed = "build_occupied_tree" if layout == "adaptive" \
        else "sparse_grid_stats"
    real = getattr(ts, probed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, probed, lambda *a: probes.append(a) or real(*a))
        sim = Simulation.create(
            system_from_numpy(pos, np.zeros_like(pos), mass, device="cpu",
                              dtype=torch.float32), cfg, method="fmm")
        if layout == "sparse":
            sim = dataclasses.replace(sim, forces_fn=functools.partial(
                TF.fmm_forces, config=cfg, order=8, layout="sparse"))
        sim = sim.run(steps=1, dt=1e-2)
        got = sim.forces()
    assert got.dtype == torch.float32
    assert bool(probes) == (layout != "dense")
    x1 = sim.system.positions.double().numpy()
    want = _direct(x1, mass.astype(np.float64), cfg)
    assert _err(got, want) < 1e-4


@pytest.mark.parametrize("n", [512, 1200])
@pytest.mark.parametrize("dim", [2, 3])
def test_fmm_matches_direct(dim, n):
    """tests/test_fmm.py's gate: order 6 within 1e-3 of the direct sum."""
    pos, mass = _bodies(n, dim, seed=n + dim)
    cfg = TGravity()
    got = TF.fmm_forces(torch.from_numpy(pos), torch.from_numpy(mass), cfg,
                        order=6, leaf_batch=256)
    assert _err(got, _direct(pos, mass, cfg)) < 1e-3


def test_fmm_converges_with_order():
    pos, mass = _bodies(1000, 2, seed=21)
    cfg = TGravity()
    want = _direct(pos, mass, cfg)
    errs = [_err(TF.fmm_forces(torch.from_numpy(pos), torch.from_numpy(mass),
                               cfg, order=o, leaf_level=3, leaf_batch=256),
                 want) for o in (2, 4, 6)]
    assert errs[1] < errs[0] and errs[2] < errs[1], errs
    assert errs[2] < 1e-4, errs


def test_fmm_order8_hits_gate():
    """The order-8 gate, 1e-4 of the direct sum, with a far field (leaf
    level 2 in 3D) and without (the default level 1 at N = 1200)."""
    pos, mass = _bodies(1200, 3, seed=22)
    cfg = TGravity()
    want = _direct(pos, mass, cfg)
    for level in (None, 2):
        got = TF.fmm_forces(torch.from_numpy(pos), torch.from_numpy(mass),
                            cfg, order=8, leaf_level=level, leaf_batch=128)
        assert _err(got, want) < 1e-4


def _clustered(n, dim, seed, frac=0.6):
    """``frac`` of the bodies in a 1e-3-wide ball, the rest in [0, 1]^D
    (tests/test_sparse_grid.py's clustered input)."""
    rng = np.random.default_rng(seed)
    nc = int(n * frac)
    pos = np.concatenate([0.5 + 1e-3 * rng.uniform(0, 1, (nc, dim)),
                          rng.uniform(0, 1, (n - nc, dim))])
    return pos, rng.uniform(0.5, 1.5, n)


@pytest.mark.parametrize("dim,order", [(2, 4), (2, 8), (3, 4)])
def test_fmm_sparse_matches_jax_f64(dim, order):
    pos, mass = _clustered(3000, dim, seed=dim)
    kw = dict(order=order, layout="sparse")
    want = JF.fmm_forces(jnp.asarray(pos), jnp.asarray(mass),
                         JGravity(G=1.0, softening=1e-4), **kw)
    have = TF.fmm_forces(torch.from_numpy(pos), torch.from_numpy(mass),
                         TGravity(G=1.0, softening=1e-4), **kw)
    assert _err(have, want) < 1e-12


@pytest.mark.parametrize("dim", [2, 3])
def test_fmm_sparse_matches_dense_uniform(dim):
    """Chunked P2M and P2P reproduce the dense FMM on a quasi-uniform
    input (same tree and expansions)."""
    pos, mass = _bodies(3000, dim, seed=30 + dim)
    args = (torch.from_numpy(pos), torch.from_numpy(mass),
            TGravity(G=1.0, softening=1e-6))
    dense = TF.fmm_forces(*args, order=4, layout="dense")
    sparse = TF.fmm_forces(*args, order=4, layout="sparse")
    assert _err(sparse, dense) < 1e-12


def test_fmm_auto_layout_on_a_degenerate_input(monkeypatch):
    """60% of the bodies in one small cell (the JAX package's own example
    of a degenerate dense layout, grid_tree.py:226-230): "auto" takes the
    sparse layout there, the port's its occupied-cell layout at the same
    leaf level (a departure: the same expansions on the same cells, so the
    same forces to the order of the sums)."""
    pos, mass = _bodies(4000, 2, seed=1)
    pos[:2400] = 5e6 + np.random.default_rng(2).uniform(0, 1, (2400, 2))
    cap = tg.compute_capacity(torch.from_numpy(pos), 4)
    assert tg.dense_layout_degenerate(cap, 4000, 4, 2)
    probes = []
    real = ts.build_occupied_tree
    monkeypatch.setattr(ts, "build_occupied_tree",
                        lambda *a: probes.append(a) or real(*a))
    want = JF.fmm_forces(jnp.asarray(pos), jnp.asarray(mass), JGravity(),
                         order=4, leaf_level=4)
    have = TF.fmm_forces(torch.from_numpy(pos), torch.from_numpy(mass),
                         TGravity(), order=4, leaf_level=4)
    assert len(probes) == 1
    assert _err(have, want) < 1e-12


def test_fmm_sparse_clustered_vs_direct():
    """FMM on the input class the dense grid refuses, against the direct
    sum (tests/test_sparse_grid.py's bound at order 5)."""
    pos, mass = _clustered(3000, 3, seed=7)
    cfg = TGravity(G=1.0, softening=1e-4)
    got = TF.fmm_forces(torch.from_numpy(pos), torch.from_numpy(mass), cfg,
                        order=5, layout="sparse")
    assert bool(torch.isfinite(got).all())
    assert _err(got, _direct(pos, mass, cfg)) < 2e-3


def test_fmm_adaptive_clustered_vs_direct():
    """The occupied-cell layout on the same input class, 2D (the 3D ball
    takes it to the keys' last level, slow on the CPU), against the direct
    sum at the same bound."""
    pos, mass = _clustered(3000, 2, seed=7)
    cfg = TGravity(G=1.0, softening=1e-4)
    got = TF.fmm_forces(torch.from_numpy(pos), torch.from_numpy(mass), cfg,
                        order=5, layout="adaptive")
    assert bool(torch.isfinite(got).all())
    assert _err(got, _direct(pos, mass, cfg)) < 2e-3


def test_fmm_bad_arguments_raise():
    pos, mass = (torch.from_numpy(a) for a in _bodies(300, 2, seed=4))
    with pytest.raises(ValueError, match="layout"):
        TF.fmm_forces(pos, mass, layout="tiled")
    with pytest.raises(ValueError, match="p2p_impl"):
        TF.fmm_forces(pos, mass, p2p_impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        TF.fmm_forces(pos, mass, p2p_impl="cuda")
    tree = tg.build_grid_tree(pos, mass, 2, tg.compute_capacity(pos, 2))
    # Sharding: the sparse layout is single-device, and a sharded call
    # names its shard.
    with pytest.raises(ValueError, match="single-device"):
        TF.fmm_accel_sorted(tree, shard_index=0, num_shards=2, num_chunks=8)
    with pytest.raises(ValueError, match="shard_index"):
        TF.fmm_accel_sorted(tree, num_shards=2)
    # The skips leave only the phases that run.
    near = TF.fmm_accel_sorted(tree, _debug_skip="m2l,l2p")
    assert torch.equal(near, tg.grid_tree_accel_sorted(
        tree, softening=0.0, p2p_impl="plain", _debug_skip="far"))
    assert torch.equal(TF.fmm_accel_sorted(tree, _debug_skip="l2p,p2p"),
                       torch.zeros_like(near))


def test_simulation_fmm_matches_jax():
    """Two leapfrog steps of Simulation("fmm") (order min(8, 8), leaf
    level 2) in G = 1 units, where the bodies move, against the JAX
    package's."""
    rng = np.random.default_rng(6)
    arrs = (rng.normal(size=(1100, 2)), 0.2 * rng.normal(size=(1100, 2)),
            np.full(1100, 1.0 / 1100))
    cfg = {"G": 1.0, "softening": 0.05}
    jsys = JSystem(*(jnp.asarray(a, jnp.float64) for a in arrs))
    tsys = system_from_numpy(*arrs, device="cpu", dtype=torch.float64)
    want = JSimulation.create(jsys, JGravity(**cfg), method="fmm")\
        .run(steps=2, dt=1e-2)
    have = Simulation.create(tsys, TGravity(**cfg), method="fmm")\
        .run(steps=2, dt=1e-2)
    assert have.step_count == 2 and have.method == "fmm"
    np.testing.assert_allclose(have.system.positions.numpy(),
                               np.asarray(want.system.positions), rtol=1e-10)
    assert _err(have.forces(), want.forces()) < 1e-10


def test_tier_f_hyperparams_match_jax():
    for n in (1000, 100_000, 1_000_000, 4_000_000, 5_000_000):
        for dim in (2, 3):
            for order in (5, 8, 12):
                assert registry.get("FMM_Chebyshev").hyperparams(
                    n, dim, TGravity(), TreeConfig(order=order)) == \
                    jreg.get("FMM_Chebyshev").hyperparams(
                        n, dim, JGravity(), JTree(order=order))
    assert registry.PORTED_TIERS == "abhf"
    assert [m.name for m in registry.methods_for_tiers("f", "cpu")] == \
        ["FMM_Chebyshev"]


def test_cli_tier_f_on_cpu(capsys):
    rc = cli.main(["-d", "3", "-N", "400", "-m", "f", "-a", "1",
                   "--device", "cpu", "--no-files", "--warmup", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "FMM_Chebyshev accuracy:" in out


@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_stages_match_jax_f64(dim):
    """The staged sharded FMM (fmm_shard_partials on a CPU mesh of 4:
    P2M and every level's M2L rows per shard, gathered, L2P and P2P per
    shard) adds up to the JAX package's evaluation of the same tree (the
    cached order-4 case), 1e-12; fmm_accel_sorted(shard_index=r) returns
    the same partials."""
    from nbody_tpu_torch.parallel.mesh import make_mesh
    tree, (acc, _, _) = _case(dim, 4)
    mesh = make_mesh([torch.device("cpu")] * 4)
    parts = TF.fmm_shard_partials(mesh.replicate(tree), mesh, order=4,
                                  softening=SOFT)
    assert _err(sum(parts), acc) < 1e-12
    one = TF.fmm_accel_sorted(tree, order=4, softening=SOFT, shard_index=2,
                              num_shards=4)
    assert torch.equal(one, parts[2])
