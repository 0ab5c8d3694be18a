"""The FMM's occupied-cell ("adaptive") layout (``ops/sparse_grid.py``'s
``OccupiedTree``, ``ops/fmm.fmm_occupied_accel_sorted``) and K6's
occupied-leaf entry (``ops/cuda_p2p.near_field_occupied_cuda``).

Against the plain f64 direct sum of ``benchmark/reference.py`` on seeded
Plummer bodies, against the dense and sparse layouts at the same explicit
leaf level (the same expansions on the same cells: only the order of the
sums differs, so 1e-12 in f64), the depth rule and the probe's counts
against a NumPy count, no tensor of 2^(D·L) elements at the keys' last
level, the ring table and its plain near field against the sparse layout's
windows, the route ``layout="auto"`` takes, and the kernel on the card.
Imports no JAX: ``python -m pytest --noconftest -m cuda`` runs the card's
test on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import reference
from nbody_tpu_torch.config import GravityConfig, TreeConfig
from nbody_tpu_torch.ops import cuda_p2p
from nbody_tpu_torch.ops import fmm as TF
from nbody_tpu_torch.ops import grid_tree as tg
from nbody_tpu_torch.ops import sparse_grid as ts
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.simulation import Simulation
from nbody_tpu_torch.state import System, plummer_system
from nbody_tpu_torch.utils import cuda_build, profiling
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K6 is built by nvcc and runs only "
                    "on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def spans_off():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _plummer(n, dim, seed, dtype=torch.float64):
    s = plummer_system(n, dim, generator=torch.Generator().manual_seed(seed),
                       device="cpu")
    return s.positions.to(dtype), s.masses.to(dtype)


def _clustered_2d(n, seed):
    """Two knots and a uniform background in 2D: a 0.03-wide Gaussian knot
    of 40% of the bodies, a 0.1-wide one of 20%, the rest in [0, 1]². (No
    pair lies within the port's 1e-5 coincidence guard, which the direct
    sum does not have.)"""
    rng = np.random.default_rng(seed)
    a, b = int(0.4 * n), int(0.2 * n)
    pos = np.concatenate([0.3 + 0.03 * rng.standard_normal((a, 2)),
                          0.7 + 0.1 * rng.standard_normal((b, 2)),
                          rng.uniform(0, 1, (n - a - b, 2))])
    return torch.from_numpy(pos), torch.from_numpy(rng.uniform(0.5, 1.5, n))


def _err(have, want):
    return float(scale_normalized_error(have, want))


def _direct(pos, mass, cfg):
    return reference.forces_on_rows(pos, mass, torch.arange(pos.shape[0]),
                                    cfg.G, cfg.softening)


# Tolerances against the direct sum, each the order's own error at the
# depth rule's level (L = 5-7 here, where the far field carries most of a
# body's force) with room; the same readings on the sparse layout at the
# same level agree to 1e-13, so they are the method's, not the layout's.
# Order 4 on 4,096 3D Plummer bodies: 3.8e-3 to 2.3e-2 over five seeds, so
# 5e-2. Order 8 on 1,000: 4.0e-6 to 2.1e-5 on four seeds and 5.0e-4 on the
# fifth (at this N a V-list cell holds a few bodies, and a body whose pull
# comes mostly from one of them reads the interpolant's error on that one;
# on 20,000 bodies order 8 read 1.2e-5 and 2.1e-5 of 4,096 rows), so 1e-3.
# Order 8 on the 2D knots: 8.6e-7 to 1.7e-6 over eight seeds, so 1e-5.
@pytest.mark.parametrize("case,order,tol", [
    ("plummer3d_4096", 4, 5e-2), ("plummer3d_1000", 8, 1e-3),
    ("knots2d_3000", 8, 1e-5)])
def test_adaptive_matches_direct_sum(case, order, tol):
    if case == "knots2d_3000":
        pos, mass = _clustered_2d(3000, seed=3)
        cfg = GravityConfig(G=1.0, softening=1e-4)
    else:
        n = int(case.split("_")[1])
        pos, mass = _plummer(n, 3, seed=n)
        cfg = GravityConfig(G=1.0, softening=4.0 / n)
    got = TF.fmm_forces(pos, mass, cfg, order=order, layout="adaptive")
    L = ts.occupied_levels(pos)[0]
    assert L >= 4, L  # the far field does most of the work
    assert _err(got, _direct(pos, mass, cfg)) < tol


@pytest.mark.parametrize("dim,level", [(2, 4), (3, 3)])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_adaptive_matches_dense_and_sparse(dim, level, layout):
    """The same leaf level in float64: the occupied cells carry the same
    weights as the grid's (an empty cell's are zero and add nothing), so
    the layouts differ only in the order of their sums. Bodies uniform in
    a ball: the box's corner cells are empty, and the dense layout's
    capacity stays small."""
    rng = np.random.default_rng(40 + dim)
    pos = rng.uniform(-1, 1, (4000, dim))
    pos = torch.from_numpy(pos[(pos ** 2).sum(1) < 1][:1500])
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, 1500))
    cfg = GravityConfig(G=1.0, softening=1e-3)
    want = TF.fmm_forces(pos, mass, cfg, order=4, leaf_level=level,
                         layout=layout)
    have = TF.fmm_forces(pos, mass, cfg, order=4, leaf_level=level,
                         layout="adaptive")
    assert _err(have, want) < 1e-12


def _numpy_levels(pos, bits):
    """Per level 1..bits: (occupied cells, fullest cell's bodies, occupied
    cells by parity class), counted with NumPy from the AABB × 1.01 grid."""
    p = pos.numpy()
    lo, hi = p.min(0), p.max(0)
    c, h = 0.5 * (lo + hi), 0.5 * (hi - lo) * np.float32(1.01) + 1e-30
    lo, hi = c - h, c + h
    out = {}
    for l in range(1, bits + 1):
        q = np.clip(np.floor((p - lo) * (2.0 ** l / (hi - lo))), 0,
                    2 ** l - 1).astype(np.int64)
        cells, counts = np.unique(q, axis=0, return_counts=True)
        cls = np.bincount((cells & 1) @ (1 << np.arange(p.shape[1]))[::-1],
                          minlength=1 << p.shape[1])
        out[l] = (len(cells), int(counts.max()), cls.tolist())
    return out


@pytest.mark.parametrize("dim", [2, 3])
def test_depth_rule_and_the_probe_counts(dim):
    """The leaf level is the shallowest whose fullest leaf holds ≤ 256
    bodies; each level's occupied cells, fullest cell and parity classes
    match a NumPy count on the same grid."""
    pos, _ = _plummer(20_000, dim, seed=7, dtype=torch.float32)
    L, levels, *_ = ts.occupied_levels(pos)
    want = _numpy_levels(pos, {2: 16, 3: 10}[dim])
    for l, (cells, fullest, cls) in want.items():
        assert levels[l] == (cells, fullest, cls), l
    assert levels[L][1] <= ts.OCCUPIED_LEAF_MAX < levels[L - 1][1]
    tree = ts.build_occupied_tree(pos, torch.ones(pos.shape[0]))
    assert tree.leaf_level == L and tree.num_leaves == levels[L][0]
    assert int(tree.leaf_count.max()) == levels[L][1]
    assert int(tree.leaf_count.sum()) == pos.shape[0]


def test_depth_rule_stops_at_leaves_of_128_softenings():
    """M2L's kernel is the unsoftened 1/r: on 60% of 3000 2D bodies in a
    1e-2 box at ε = 1e-4, the fullest-leaf rule alone goes to L = 9
    (leaves of 20ε), where order 8 reads 1.1e-3 against the direct sum;
    the depth rule stops at the deepest level whose leaves span 128ε (L =
    6, 160ε), which reads 5.7e-7, so 1e-5. Against the port's direct sum,
    whose 1e-5 coincidence guard the FMM's near field shares: a few of the
    box's pairs lie that close."""
    rng = np.random.default_rng(8)
    pos = torch.from_numpy(np.concatenate([
        0.5 + 1e-2 * rng.uniform(0, 1, (1800, 2)),
        rng.uniform(0, 1, (1200, 2))]))
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, 3000))
    cfg = GravityConfig(G=1.0, softening=1e-4)
    assert ts.occupied_levels(pos)[0] == 9
    L = ts.occupied_levels(pos, softening=cfg.softening)[0]
    side = float((pos.max(0).values - pos.min(0).values).min()) * 1.01 / 2 ** L
    assert L == 6 and 128 * cfg.softening <= side < 256 * cfg.softening
    got = TF.fmm_forces(pos, mass, cfg, order=8, layout="adaptive")
    assert _err(got, brute_force_direct(pos, mass, cfg)) < 1e-5


class _LargestTensor(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_no_dense_tensor_at_the_keys_last_level():
    """A build and an evaluation at L = 10 in 3D (2^30 leaf cells) on 600
    bodies: no tensor comes near 2^(D·L) elements, and the forces hold to
    the direct sum."""
    pos, mass = _plummer(600, 3, seed=11)
    cfg = GravityConfig(G=1.0, softening=4.0 / 600)
    with _LargestTensor() as mode:
        got = TF.fmm_forces(pos, mass, cfg, order=3, leaf_level=10,
                            layout="adaptive")
    assert mode.largest < (1 << 30) // 64, mode.largest
    # Order 3 through nine levels reads 9.1e-2: the check is that the
    # evaluation is whole, not its order's accuracy (the tests above hold
    # that).
    assert _err(got, _direct(pos, mass, cfg)) < 0.2


@pytest.mark.parametrize("dim,level", [(2, 5), (3, 4)])
def test_ring_table_and_its_plain_near_field(dim, level):
    """Each leaf's ring table row names the occupied leaves of its
    (2k+1)^D neighbour cells (−1 for the others), and the plain near field
    over it equals the sparse layout's windowed near field
    (``near_field_windows``) on the grid tree of the same level."""
    pos, mass = _plummer(3000, dim, seed=20 + dim)
    tree = ts.build_occupied_tree(pos, mass, level)
    table = ts.occupied_ring_table(tree, 1)
    kL = tree.keys[level]
    xy = tg.cell_coords(kL, dim)[:, None, :] + torch.as_tensor(
        tg._neighbor_offsets(dim, 1))
    inside = tg._in_bounds(xy, level)
    ids = tg._clipped_ids(xy, level, dim, xy.shape[:-1])
    occupied = torch.isin(ids, kL) & inside
    assert torch.equal(table >= 0, occupied)
    assert torch.equal(kL[table.clamp(min=0)][occupied], ids[occupied])
    soft = 1e-3
    have = cuda_p2p.near_field_occupied_plain(tree, table, soft)
    num_chunks, max_windows = ts.sparse_grid_stats(pos, level, 64, 8, 1)
    grid = tg.build_grid_tree(pos, mass, level, 8, agg_num_chunks=num_chunks,
                              agg_chunk_size=64)
    chunks = TF._sparse_chunks(grid, num_chunks, 64, 1024)
    want = TF._near_sparse(grid, chunks, 64, 1, 8, max_windows, soft)
    # Each tree sorts by its own keys (the grid's by the leaf's, stably):
    # compare in the bodies' own order.
    have[tree.order], want[grid.order] = have.clone(), want.clone()
    assert _err(have, want) < 1e-12


def _brute_pair_counts(tree):
    """(M2L's occupied V-list pairs over levels 2..L, the near field's body
    pairs), enumerated over every pair of occupied cells and of bodies:
    a V-list pair's cells are not neighbours and their parents are, and a
    near pair's bodies lie in neighbouring leaves (itself included)."""
    dim, L = tree.dim, tree.leaf_level

    def adjacent(a, b):
        return ((a[:, None, :] - b[None, :, :]).abs() <= 1).all(-1)

    v_pairs = 0
    for l in range(2, L + 1):
        xy = tg.cell_coords(tree.keys[l], dim)
        v_pairs += int((adjacent(xy >> 1, xy >> 1) & ~adjacent(xy, xy))
                       .sum())
    leaf_xy = tg.cell_coords(tree.keys[L], dim)[tree.body_leaf]
    return v_pairs, int(adjacent(leaf_xy, leaf_xy).sum())


def test_auto_route_and_its_counters(monkeypatch):
    """``layout="auto"``: the capacity guard trips on a Plummer core and
    the occupied-cell tree serves it (capacity probe, depth probe, and on
    the CPU the plain near field's size: 3 read-backs), at the depth
    rule's level, or at a leaf level given. ``fmm.occupied_cells`` sums
    the cells of levels 2..L, ``fmm.m2l_products`` the classes' padded
    rows × 189 offsets, and ``fmm.m2l_pairs`` and ``fmm.near_pairs`` what
    a brute enumeration of cell and body pairs counts."""
    pos, mass = _plummer(4000, 3, seed=5, dtype=torch.float32)
    cfg = GravityConfig(G=1.0, softening=1e-3)
    L0 = tg.auto_leaf_level(4000, 3)
    assert tg.dense_layout_degenerate(tg.compute_capacity(pos, L0), 4000, L0,
                                      3)
    calls = []
    for name in ("build_occupied_tree", "sparse_grid_stats"):
        real = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    profiling.enable_spans()
    got = Simulation.create(System(pos, torch.zeros_like(pos), mass), cfg,
                            TreeConfig(order=4), method="fmm").forces()
    assert calls == ["build_occupied_tree"]
    counters = profiling.counter_totals()
    tree = ts.build_occupied_tree(pos, mass, None, cfg.softening)
    L = tree.leaf_level
    assert counters["fmm.reads"] == 3
    assert counters["fmm.occupied_cells"] == sum(tree.cells[2:L + 1])
    assert counters["fmm.m2l_products"] == sum(
        8 * tree.class_rows[l] * 189 for l in range(2, L + 1))
    assert (counters["fmm.m2l_pairs"], counters["fmm.near_pairs"]) \
        == _brute_pair_counts(tree)
    assert torch.equal(got, TF.fmm_forces(pos, mass, cfg, order=4,
                                          layout="adaptive"))
    calls.clear()
    got = TF.fmm_forces(pos, mass, cfg, order=4, leaf_level=L0)
    assert calls == ["build_occupied_tree"]
    assert torch.equal(got, TF.fmm_forces(pos, mass, cfg, order=4,
                                          leaf_level=L0, layout="adaptive"))


@pytest.mark.parametrize("dim,level", [(2, 9), (3, 6)])
def test_pair_counters_match_enumeration(dim, level):
    """The counters' device sums (M2L's pairs of every level in one tagged
    lookup, the near field's over the ring table) against the brute
    enumeration, deep enough that the levels' ids share no range."""
    pos, mass = _clustered_2d(2000, seed=12) if dim == 2 else _plummer(
        2000, 3, seed=12)
    tree = ts.build_occupied_tree(pos, mass, level)
    dq = TF._m2l_operators(tree, 3, 1)[0]
    got = (int(TF._m2l_pairs(tree, dq)), int(ts.occupied_ring_pairs(
        tree, ts.occupied_ring_table(tree, 1))))
    assert got == _brute_pair_counts(tree)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level", [(3, 10), (3, 4), (2, 8)])
def test_occupied_kernel_matches_its_plain_version_on_card(cuda_device, dim,
                                                           level):
    """K6's occupied-leaf entry (fp32, one launch) against the f64 plain
    version on the same fp32 positions, at softening 0 and 1e-3; the
    shallow 3D level puts hundreds of bodies in a leaf (many 32-body
    chunks, each its own warp)."""
    pos, mass = _plummer(20_000, dim, seed=9, dtype=torch.float32)
    pos, mass = pos.to(cuda_device), mass.to(cuda_device)
    t32 = ts.build_occupied_tree(pos, mass, level)
    # The same fp32 tree in f64: both sides see the same positions.
    t64 = dataclasses.replace(t32, **{
        f.name: getattr(t32, f.name).double()
        for f in dataclasses.fields(t32)
        if torch.is_tensor(getattr(t32, f.name))
        and getattr(t32, f.name).is_floating_point()})
    table = ts.occupied_ring_table(t32, 1)
    for soft in (0.0, 1e-3):
        before = cuda_build.LAUNCHES["near_field_occupied"]
        have = cuda_p2p.near_field_occupied_cuda(t32, table, soft)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["near_field_occupied"] == before + 1
        want = cuda_p2p.near_field_occupied_plain(t64, table, soft)
        err = _err(have.double(), want)
        # As K6's tree entry: 8 ulps of the largest force where one near
        # pair sets it.
        f = want.norm(dim=-1)
        tol = max(1e-5, 8 * 2.0 ** -24 * float(f.max() / f.pow(2).mean()
                                               .sqrt()))
        assert bool(torch.isfinite(have).all()) and err < tol, (err, tol)
