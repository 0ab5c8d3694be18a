"""K6's tree kernel, the path's near field (ops/cuda_p2p.near_field_cuda,
csrc/p2p_leaf.cu nbody_near_field).

On the CPU: a pure-torch emulation of the kernel's walk (its CTAs of
leaves, each leaf's ring of neighbour cells enumerated from its Morton id
and clipped at the grid's edge, the non-empty cells as runs, the target
chunks and lane splits, the ring buffer's tiles of 32 real sources) gives
exactly the (target, source) pairs that ``grid_tree.near_field_inputs``
forms, in both of its layouts, and sums that match the plain near field;
the kernel's constants are read from the source (no nvcc here). The
``cuda``-marked tests run the kernel itself and skip without a card; they
need no JAX (``pytest --noconftest -m cuda`` on the card). The plain near
field against the JAX package is in ``tests/test_torch_p2p.py``.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import cuda_p2p
from nbody_tpu_torch.ops import grid_tree as tg
from nbody_tpu_torch.ops.keys import _spread2, _spread3
from nbody_tpu_torch.utils import cuda_build
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

SOURCE = (Path(cuda_build.__file__).resolve().parent.parent / "csrc"
          / "p2p_leaf.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WARPS = _constant("kNearWarps")
RING = _constant("kNearRing")
TILE = 32  # one fp32 chain (pair_law.cuh kChain, asserted in the source)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K6 is built by nvcc and runs only "
                    "on the card")
    return torch.device("cuda", 0)


def _tree(n, dim, level, seed, device="cpu", unit=False,
          dtype=torch.float64):
    """A tree over n bodies with one leaf packed beyond two warps' worth of
    targets (a cluster of 70 bodies), coincident twins and zero masses.
    ``unit``: coordinates in [0, 1] with twins straddling a cell boundary
    2e-6 apart (raw d² < 1e-10 across two leaves)."""
    rng = np.random.default_rng(seed)
    scale = 1.0 if unit else 1e7
    pos = rng.uniform(0.0, scale, (n, dim))
    pos[:70] = pos[70] + rng.uniform(0.0, 1e-3 * scale / (1 << level),
                                     (70, dim))
    pos[100:110] = pos[110:120]  # coincident twins in one leaf
    if unit:
        pos[0], pos[1] = 0.0, 1.0  # the bounds stay [0, 1]
        side = 1.01 / (1 << level)
        for j in range(200, 220, 2):
            edge = -0.005 + side * rng.integers(1, (1 << level) - 1)
            pos[j, 0], pos[j + 1, 0] = edge - 1e-6, edge + 1e-6
            pos[j + 1, 1:] = pos[j, 1:]
    mass = rng.uniform(0.5, 1.5, n)
    mass[::7] = 0.0
    p = torch.from_numpy(pos).to(device, dtype)
    m = torch.from_numpy(mass).to(device, dtype)
    return tg.build_grid_tree(p, m, level, tg.compute_capacity(p, level))


def _emulate(tree, k, leaf0, nleaves):
    """The kernel's walk, in its order: returns the (target, source) pairs
    its written lanes sum, as an [P, 2] int64 tensor."""
    dim, side = tree.dim, 1 << tree.leaf_level
    start, count = tree.cell_start.tolist(), tree.cell_count.tolist()
    spread = _spread2 if dim == 2 else _spread3
    w = 2 * k + 1
    ncell = w ** dim
    offs = np.stack(np.unravel_index(np.arange(ncell), (w,) * dim), -1) - k
    pairs = []
    for cta in range(-(-nleaves // WARPS)):
        for warp in range(WARPS):
            li = cta * WARPS + warp
            if li >= nleaves:
                continue
            leaf = leaf0 + li
            xy = tg.cell_coords(torch.tensor([leaf]), dim)[0].numpy()
            runs = []
            for base in range(0, ncell, 32):  # lane j takes cell base + j
                for i in range(base, min(base + 32, ncell)):
                    c = xy + offs[i]
                    if ((c < 0) | (c >= side)).any():
                        continue
                    sp = [int(spread(torch.tensor(int(v)))) for v in c]
                    cid = sum(v << (dim - 1 - d) for d, v in enumerate(sp))
                    if count[cid] > 0:  # the ballot's non-empty cells
                        runs.append((start[cid], count[cid]))
            cs, nt = start[leaf], count[leaf]
            for c0 in range(0, nt, 32):
                m = min(32, nt - c0)
                tp = 1 << (m - 1).bit_length()
                tiles, ring = [], []
                for st, ln in runs:
                    for o in range(0, ln, 32):
                        ring += range(st + o, st + min(ln, o + 32))
                        if len(ring) >= TILE:
                            tiles.append(ring[:TILE])
                            ring = ring[TILE:]
                        assert len(ring) < RING - 32
                if ring:  # the last tile, padded with mass-0 bodies
                    tiles.append(ring + [-1] * (TILE - len(ring)))
                for lane in range(32):
                    t, s = lane & (tp - 1), lane // tp
                    if t >= m:  # lanes whose totals no split 0 takes
                        continue
                    for tile in tiles:
                        for src in tile[s * tp:(s + 1) * tp]:
                            if src >= 0:
                                pairs.append((cs + c0 + t, src))
    return torch.tensor(pairs, dtype=torch.int64).reshape(-1, 2)


def _window_pairs(tree, k, ids):
    """The (target, source) pairs of ``near_field_inputs`` for leaves
    ``ids``: each body's mass slot carries its sorted index + 1, so a
    source the windows mask out reads 0."""
    bp = tree.body_pack.clone().reshape(-1, 4)
    bp[:, 3] = torch.arange(1, bp.shape[0] + 1, dtype=bp.dtype)
    tagged = dataclasses.replace(tree, body_pack=bp.reshape(-1, 32))
    tb, gidx, tvalid = tg._window_rows(tagged, ids)
    calls, shared = tg.near_field_inputs(tagged, k, ids, tb)
    nch, twr = 1 << tree.dim, tb.shape[1]
    targets = ([(gidx.reshape(-1, nch, twr)[:, pm],
                 tvalid.reshape(-1, nch, twr)[:, pm]) for pm in range(nch)]
               if shared else [(gidx, tvalid)])
    assert shared == (k >= 2 and ids.numel() % nch == 0)
    pairs = []
    for (g, v), (_, src4) in zip(targets, calls):
        sid = src4[..., 3].round().long() - 1
        for row in range(g.shape[0]):
            t, s = g[row][v[row]], sid[row][sid[row] >= 0]
            pairs.append(torch.stack(torch.meshgrid(t, s, indexing="ij"),
                                     -1).reshape(-1, 2))
    return torch.cat(pairs)


def _sorted_keys(pairs, n):
    return torch.sort(pairs[:, 0] * n + pairs[:, 1]).values


def _pair_sums(tree, pairs, softening):
    """Σ over the pairs of m_s (x_s − x_t) u³ with the raw-d² guard, f64."""
    pos, mass = tree.pos_sorted, tree.mass_sorted
    t, s = pairs[:, 0], pairs[:, 1]
    diff = pos[s] - pos[t]
    d2 = (diff * diff).sum(-1)
    u = torch.rsqrt(d2 + softening ** 2)
    wt = torch.where(d2 < 1e-10, torch.zeros_like(d2), mass[s] * u ** 3)
    return torch.zeros_like(pos).index_add_(0, t, wt[:, None] * diff)


# (dim, level, k, segments, leaf batch of the windows): edge leaves on
# every side; k ≥ 2 with a batch of 2^D multiples takes the parent-shared
# layout, the others the per-leaf one.
_CASES = [(2, 3, 1, 1, 64), (2, 3, 2, 4, 16), (2, 3, 3, 1, 64),
          (2, 3, 3, 1, 7), (3, 2, 1, 4, 16), (3, 2, 2, 1, 64),
          (3, 2, 3, 1, 64), (3, 2, 2, 2, 5)]


@pytest.mark.parametrize("dim,level,k,segments,batch", _CASES)
def test_kernel_walk_forms_the_window_pair_set(dim, level, k, segments,
                                               batch):
    tree = _tree(900 if dim == 2 else 700, dim, level, seed=level + k)
    assert int(tree.cell_count.max()) > 64  # a leaf of three target chunks
    nl = tree.num_leaf_cells // segments
    for si in range(segments):
        have = _emulate(tree, k, si * nl, nl)
        want = torch.cat([_window_pairs(tree, k, torch.arange(b, min(
            b + batch, (si + 1) * nl))) for b in range(si * nl,
                                                       (si + 1) * nl, batch)])
        assert torch.equal(_sorted_keys(have, tree.n),
                           _sorted_keys(want, tree.n))
        assert have.shape[0] == cuda_p2p.near_field_pairs(tree, k, si * nl,
                                                          nl)
        for soft in (0.0, 1e-6 * 1e7):
            got = _pair_sums(tree, have, soft)
            plain = cuda_p2p.near_field_plain(tree, k, soft, si * nl, nl)
            assert float(scale_normalized_error(got, plain)) < 1e-12


def test_near_field_pairs_counts_edge_clipped_rings():
    """One body a cell: each leaf's pairs are its in-grid ring cells."""
    side, k = 8, 2
    xy = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                              indexing="ij"), -1).reshape(-1, 2)
    pos = torch.from_numpy((xy + 0.5) / side)
    tree = tg.build_grid_tree(pos, torch.ones(side * side), 3, 8)
    per_axis = [min(i + k, side - 1) - max(i - k, 0) + 1 for i in range(side)]
    assert cuda_p2p.near_field_pairs(tree, k) == sum(per_axis) ** 2
    assert cuda_p2p.near_field_pairs(tree, k, 0, 1) == 9


def test_near_field_cuda_on_cpu_takes_the_plain_version():
    tree = _tree(900, 2, 3, seed=1)
    before = dict(cuda_build.LAUNCHES)
    have = cuda_p2p.near_field_cuda(tree, 3, 1.0, 16, 32)
    assert cuda_build.LAUNCHES == before
    assert have.dtype == torch.float64 and have.shape == (tree.n, 2)
    assert torch.equal(have, cuda_p2p.near_field_plain(tree, 3, 1.0, 16, 32))
    outside = (tree.leaf_ids < 16) | (tree.leaf_ids >= 48)
    assert not have[outside].any() and have[~outside].abs().sum() > 0


def test_near_field_plain_is_the_paths_plain_near_field():
    """grid_tree_accel_sorted(p2p_impl="plain", far skipped) is the plain
    near field of the segment; its leaf batches (either layout) do not
    change it beyond rounding."""
    tree = _tree(900, 2, 3, seed=2)
    for si in range(2):
        path = tg.grid_tree_accel_sorted(tree, k=2, softening=1.0,
                                         leaf_batch=8, p2p_impl="plain",
                                         num_segments=2, segment_index=si,
                                         _debug_skip="far")
        assert torch.equal(path, cuda_p2p.near_field_plain(
            tree, 2, 1.0, 32 * si, 32, leaf_batch=8))
        other = cuda_p2p.near_field_plain(tree, 2, 1.0, 32 * si, 32,
                                          leaf_batch=3)
        assert float(scale_normalized_error(other, path)) < 1e-14


def test_near_field_rejects_leaf_ranges_outside_the_tree():
    tree = _tree(900, 2, 3, seed=3)
    for leaf0, nleaves in ((-1, 4), (60, 8), (0, 65)):
        with pytest.raises(ValueError, match="outside"):
            cuda_p2p.near_field_cuda(tree, 1, 0.0, leaf0, nleaves)
        with pytest.raises(ValueError, match="outside"):
            cuda_p2p.near_field_pairs(tree, 1, leaf0, nleaves)


def test_near_field_buffers_are_the_trees_own():
    """An fp32 tree's bodies and cell tables go to the kernel uncopied."""
    tree = _tree(900, 3, 2, seed=4)
    t32 = dataclasses.replace(tree, body_pack=tree.body_pack.float())
    body4, start, count = cuda_p2p.near_field_buffers(t32)
    assert body4.data_ptr() == t32.body_pack.data_ptr()
    assert body4.shape == (t32.body_pack.shape[0] * 8, 4)
    assert start.data_ptr() == tree.cell_start.data_ptr()
    assert count.data_ptr() == tree.cell_count.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level,k,segments", [
    (2, 5, 3, 1), (2, 4, 1, 4), (3, 3, 3, 4), (3, 3, 1, 1)])
def test_near_field_kernel_matches_plain_on_card(cuda_device, dim, level, k,
                                                 segments):
    """The kernel (fp32) against its f64 plain version, segment by segment,
    one launch each, at softening 0 (twins across a leaf boundary) and a
    softening."""
    n = 20_000 if dim == 2 else 8_000
    t32 = _tree(n, dim, level, seed=5, device=cuda_device, unit=True,
                dtype=torch.float32)
    # The same fp32 tree in f64: both sides see the same positions.
    t64 = dataclasses.replace(t32, **{
        f.name: getattr(t32, f.name).double()
        for f in dataclasses.fields(t32)
        if torch.is_tensor(getattr(t32, f.name))
        and getattr(t32, f.name).is_floating_point()})
    nl = t64.num_leaf_cells // segments
    for soft in (0.0, 1e-3):
        before = cuda_build.LAUNCHES["near_field"]
        have = sum(cuda_p2p.near_field_cuda(t32, k, soft, si * nl, nl)
                   for si in range(segments))
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["near_field"] == before + segments
        want = cuda_p2p.near_field_plain(t64, k, soft)
        err = float(scale_normalized_error(have.double(), want))
        # Where one near pair makes a body's force far above the RMS, that
        # pair's fp32 term sets the error: 8 ulps of the largest force
        # (chip_smoke.py K6_ULPS has the derivation).
        f = want.norm(dim=-1)
        tol = max(1e-5, 8 * 2.0 ** -24 * float(f.max() / f.pow(2).mean()
                                               .sqrt()))
        assert bool(torch.isfinite(have).all()) and err < tol, (err, tol)


@pytest.mark.parametrize("name,source", [("nbody_near_field", "p2p_leaf.cu"),
                                         ("nbody_p2p_leaf", "p2p_leaf.cu"),
                                         ("nbody_matmul_probe",
                                          "rate_probe.cu")])
def test_c_abi_arity_matches_the_ctypes_signatures(name, source):
    text = (Path(cuda_build.SOURCE_DIR) / source).read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    assert m, name
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(cuda_build._SIGNATURES[name][0])
