"""Leaf near field of the grid tree through the hand-written CUDA kernel K6.

Port of ``nbody_tpu.ops.pallas_p2p`` (``_kernel``, built by
``p2p_leaf_pallas``): for each target, ``Σ_s m_s·(x_s − x_t)·u³`` over the
bodies of the (2k+1)^D neighbour cells of its leaf, u = (d² + ε²)^{-1/2},
u³ zeroed where the raw d² < 1e-10, always. Mass 0 marks an invalid source.
``csrc/p2p_leaf.cu`` has three entries on one pair loop:

* :func:`near_field_cuda`, the Barnes-Hut path's: the kernel reads the tree
  itself (the sorted bodies ``body_pack``, ``cell_start``, ``cell_count``),
  finds each leaf's neighbour cells from its Morton id, evaluates real pairs
  only, and writes [N, D] in sorted-body order: one launch per segment.
  Each launch adds one to ``cuda_build.LAUNCHES["near_field"]``. Its plain
  version, :func:`near_field_plain`, forms the windows of
  ``grid_tree.near_field_inputs`` batch by batch and sums them with
  :func:`p2p_plain`. :func:`near_field_launch` is the bare launch, so the
  kernel can be timed alone, and :func:`near_field_pairs` counts the real
  pairs of a launch.
* :func:`near_field_occupied_cuda`, the FMM's occupied-cell layout's
  (``sparse_grid.OccupiedTree``, no counterpart in the JAX package): the
  kernel reads each leaf's ring from a [leaves, (2k+1)^D] table of leaf
  rows (``sparse_grid.occupied_ring_table``), one warp a 32-body target
  chunk, and writes every body's row in sorted order: one launch a call,
  ``LAUNCHES["near_field_occupied"]``. Its plain version,
  :func:`near_field_occupied_plain`, sums each body's ring sources laid
  end to end.
* :func:`p2p_leaf_cuda`, the window entry in the JAX kernel's layout (one
  row of gathered sources per leaf), which the tests hold against
  ``p2p_leaf_pallas``: K6's window kernel on CUDA tensors,
  ``LAUNCHES["p2p_leaf"]``; :func:`p2p_plain` on CPU tensors.
  :func:`p2p_leaf_plain` takes the JAX layout itself.

Each wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from ..utils.cuda_build import LAUNCHES
from .cuda_brute import _device_kind, _stream
from .grid_tree import (GridTree, _point_mass_accel, _window_rows,
                        cell_coords, near_batch_plan, near_field_inputs)

# Leaf rows per plain-version step: keeps each [rows, C, S] temporary at
# 2^27 elements however long the rows are.
_PLAIN_TILE_ELEMS = 1 << 27


def _check(tpos, src4):
    if tpos.dim() != 3 or tpos.shape[-1] not in (2, 3):
        raise ValueError(f"targets must be [B, C, 2|3], got "
                         f"{tuple(tpos.shape)}")
    if src4.dim() != 3 or src4.shape[-1] != 4 or \
            src4.shape[0] != tpos.shape[0]:
        raise ValueError(f"sources must be [B, S, 4] with B = "
                         f"{tpos.shape[0]}, got {tuple(src4.shape)}")


def p2p_plain(tpos, src4, softening, tile_elems: int = _PLAIN_TILE_ELEMS):
    """Plain version of K6 on the packed layout: tpos [B, C, D], src4
    [B, S, 4] → [B, C, D] in the inputs' dtype, in row blocks of at most
    ``tile_elems`` pairs (one row at least)."""
    dim = tpos.shape[-1]
    b, c, _ = tpos.shape
    rows = max(1, tile_elems // max(c * src4.shape[1], 1))
    if b <= rows:
        return _point_mass_accel(tpos, src4[..., :dim], src4[..., 3],
                                 softening)
    return torch.cat([
        _point_mass_accel(tpos[r:r + rows], src4[r:r + rows, :, :dim],
                          src4[r:r + rows, :, 3], softening)
        for r in range(0, b, rows)])


def _leaf_range(tree: GridTree, leaf0: int, nleaves):
    nleaves = tree.num_leaf_cells - leaf0 if nleaves is None else nleaves
    if leaf0 < 0 or nleaves < 0 or leaf0 + nleaves > tree.num_leaf_cells:
        raise ValueError(f"leaves [{leaf0}, {leaf0 + nleaves}) outside the "
                         f"tree's {tree.num_leaf_cells}")
    return int(leaf0), int(nleaves)


def near_field_plain(tree: GridTree, k: int, softening: float,
                     leaf0: int = 0, nleaves=None,
                     leaf_batch: int = 512) -> torch.Tensor:
    """Plain version of :func:`near_field_cuda`: the leaves [leaf0, leaf0 +
    nleaves) in batches of ``leaf_batch`` (clamped as
    ``grid_tree.near_batch_plan`` clamps it), each as the windows of
    ``grid_tree.near_field_inputs`` summed by :func:`p2p_plain`, scattered
    to sorted-body order. Returns [N, D] in the tree's dtype, zero outside
    the leaves."""
    leaf0, nleaves = _leaf_range(tree, leaf0, nleaves)
    dim = tree.dim
    twr = (tree.capacity // 8 + 1) * 8
    out = tree.pos_sorted.new_zeros((tree.n, dim))
    lb = max(1, min(near_batch_plan(tree, k, leaf_batch)[0], nleaves))
    dev = tree.pos_sorted.device
    for b0 in range(leaf0, leaf0 + nleaves, lb):
        ids = torch.arange(b0, min(b0 + lb, leaf0 + nleaves), device=dev)
        tb, gidx, tvalid = _window_rows(tree, ids)  # [B, TWR, ...]
        calls, shared = near_field_inputs(tree, k, ids, tb)
        parts = [p2p_plain(t, s, softening) for t, s in calls]
        acc = (torch.stack(parts, dim=1).reshape(ids.numel(), twr, dim)
               if shared else parts[0])
        out[gidx[tvalid]] = acc[tvalid]
    return out


def near_field_buffers(tree: GridTree):
    """K6's inputs from the tree, without copies for an fp32 tree: the
    sorted bodies as float4 rows [N8, 4] (x, y, z|0, m) and the int64 cell
    tables."""
    body4 = tree.body_pack.to(torch.float32).reshape(-1, 4).contiguous()
    return (body4, tree.cell_start.to(torch.int64).contiguous(),
            tree.cell_count.to(torch.int64).contiguous())


def near_field_launch(bufs, out, *, dim, leaf_level, k, leaf0, nleaves,
                      softening):
    """One launch of K6's tree kernel on :func:`near_field_buffers`'
    tensors, writing the rows of the leaves' bodies into ``out`` [N, D]
    fp32. It counts nothing: :func:`near_field_cuda` counts its launches."""
    body4, start, count = bufs
    code = cuda_build.load_library().nbody_near_field(
        body4.data_ptr(), start.data_ptr(), count.data_ptr(), out.data_ptr(),
        dim, leaf_level, k, leaf0, nleaves, float(softening) ** 2, _stream())
    cuda_build.check(code, "near_field kernel")


def near_field_cuda(tree: GridTree, k: int, softening: float,
                    leaf0: int = 0, nleaves=None,
                    leaf_batch: int = 512) -> torch.Tensor:
    """Near-field accelerations [N, D] of the bodies of leaves [leaf0,
    leaf0 + nleaves) in sorted-body order, zero elsewhere, not scaled by G.

    On a CUDA tree one K6 launch (computed in fp32, cast back to the tree's
    dtype); on a CPU tree :func:`near_field_plain` (``leaf_batch`` sets its
    batches only).
    """
    leaf0, nleaves = _leaf_range(tree, leaf0, nleaves)
    if _device_kind(tree.body_pack, tree.cell_start) == "cpu":
        return near_field_plain(tree, k, softening, leaf0, nleaves,
                                leaf_batch)
    if tree.n >= 1 << 31:
        raise ValueError(f"near_field kernel: N = {tree.n} needs 32-bit "
                         f"body indices")
    out = torch.zeros((tree.n, tree.dim), dtype=torch.float32,
                      device=tree.body_pack.device)
    near_field_launch(near_field_buffers(tree), out, dim=tree.dim,
                      leaf_level=tree.leaf_level, k=k, leaf0=leaf0,
                      nleaves=nleaves, softening=softening)
    LAUNCHES["near_field"] += 1
    return out.to(tree.pos_sorted.dtype)


def _box_sums(grid, k):
    """Σ over the (2k+1)^D box around every cell of an int64 grid, cells
    outside the grid counting 0 (exact: prefix sums per axis)."""
    for ax in range(grid.dim()):
        side = grid.shape[ax]
        c = torch.cat([torch.zeros_like(grid.narrow(ax, 0, 1)),
                       grid.cumsum(ax)], dim=ax)
        i = torch.arange(side, device=grid.device)
        grid = (c.index_select(ax, (i + k).clamp(max=side - 1) + 1)
                - c.index_select(ax, (i - k).clamp(min=0)))
    return grid


def near_field_pairs(tree: GridTree, k: int, leaf0: int = 0,
                     nleaves=None) -> int:
    """The real (target, source) pairs of the near field of leaves [leaf0,
    leaf0 + nleaves): Σ over leaves of its bodies × the bodies of its
    in-grid (2k+1)^D neighbour cells, itself included."""
    leaf0, nleaves = _leaf_range(tree, leaf0, nleaves)
    dim, side = tree.dim, 1 << tree.leaf_level
    ids = torch.arange(tree.num_leaf_cells, device=tree.cell_count.device)
    xy = cell_coords(ids, dim).unbind(-1)
    grid = tree.cell_count.new_zeros((side,) * dim, dtype=torch.int64)
    grid[xy] = tree.cell_count.to(torch.int64)
    ring = _box_sums(grid, k)[xy]
    sel = slice(leaf0, leaf0 + nleaves)
    return int((tree.cell_count[sel].to(torch.int64) * ring[sel]).sum())


def p2p_leaf_pack(tpos, src4):
    """K6's fp32 buffers for [B, C, D] targets and [B, S, 4] sources:
    targets as float4 rows [B, C, 4] (columns ≥ D zero), the sources, and
    the output [B, C, 4]."""
    b, c, dim = tpos.shape
    t4 = torch.zeros((b, c, 4), dtype=torch.float32, device=tpos.device)
    t4[..., :dim] = tpos
    out = torch.empty((b, c, 4), dtype=torch.float32, device=tpos.device)
    return t4, src4.to(torch.float32).contiguous(), out


def p2p_leaf_launch(t4, s4, out, dim, softening):
    """One launch of K6's window kernel on :func:`p2p_leaf_pack`'s buffers,
    writing ``out``. It counts nothing: :func:`p2p_leaf_cuda` counts its
    launches."""
    b, c, _ = t4.shape
    code = cuda_build.load_library().nbody_p2p_leaf(
        t4.data_ptr(), s4.data_ptr(), out.data_ptr(), b, c, s4.shape[1], dim,
        float(softening) ** 2, _stream())
    cuda_build.check(code, "p2p_leaf kernel")


def p2p_leaf_cuda(tpos, src4, *, softening):
    """Leaf near-field accelerations [B, C, D], not scaled by G, in the
    window layout.

    tpos: [B, C, D] targets; src4: [B, S, 4] packed (pos|0, mass) sources,
    mass 0 for invalid ones. K6's window kernel on CUDA tensors (computed in
    fp32, cast back to ``tpos.dtype``), :func:`p2p_plain` on CPU tensors.
    """
    _check(tpos, src4)
    if _device_kind(tpos, src4) == "cpu":
        return p2p_plain(tpos, src4, softening)
    b, c, dim = tpos.shape
    if b == 0 or c == 0:
        return tpos.new_zeros(tpos.shape)
    t4, s4, out = p2p_leaf_pack(tpos, src4)
    p2p_leaf_launch(t4, s4, out, dim, softening)
    LAUNCHES["p2p_leaf"] += 1
    return out[..., :dim].to(tpos.dtype)


def p2p_leaf_plain(tpos4, src8, *, dim, softening):
    """Plain version in the JAX kernel's layout: tpos4 [NL, C, 4] (columns
    ≥ dim zero), src8 [NL, 8, S] (rows 0..dim−1 coordinates, row 3 mass)
    → [NL, C, 4], columns ≥ dim zero."""
    src4 = torch.cat([src8[:, :3, :], src8[:, 3:4, :]], dim=1).transpose(1, 2)
    acc = p2p_plain(tpos4[..., :dim], src4, softening)
    out = tpos4.new_zeros(tpos4.shape)
    out[..., :dim] = acc
    return out


# --- The occupied-cell tree's near field --------------------------------------

def near_field_occupied_plain(tree, table: torch.Tensor,
                              softening: float) -> torch.Tensor:
    """Plain version of :func:`near_field_occupied_cuda` in the tree's
    dtype: each sorted body (one target a row, in blocks of rows) against
    the bodies of its leaf's ring in ``table`` (−1 entries skipped), laid
    end to end up to the longest ring's total (read back once, counted in
    ``fmm.reads``), summed by :func:`p2p_plain`. Returns [N, D] in
    sorted-body order."""
    from ..utils.profiling import count
    dim, n = tree.dim, tree.n
    body = tree.body_pack
    rc = table.clamp(min=0)
    rcnt = torch.where(table >= 0, tree.leaf_count[rc], 0)  # [leaves, nc]
    rend = torch.cumsum(rcnt, 1)  # end of each ring cell's run of sources
    rstart = tree.leaf_start[rc] - (rend - rcnt)
    count("fmm.reads")
    smax = max(1, int(rend[:, -1].max()))
    slots = torch.arange(smax, device=body.device)
    out = body.new_empty((n, dim))
    rows = max(1, _PLAIN_TILE_ELEMS // smax)
    for b0 in range(0, n, rows):
        leaf = tree.body_leaf[b0:b0 + rows]
        # Source slot s of a row lies in the ring cell j whose run holds it.
        j = torch.searchsorted(rend[leaf], slots.expand(leaf.shape[0], smax)
                               .contiguous(), right=True)
        valid = j < table.shape[1]
        jc = j.clamp(max=table.shape[1] - 1)
        src = body[(torch.gather(rstart[leaf], 1, jc) + slots).clamp(0, n - 1)]
        src = torch.cat([src[..., :3], (src[..., 3] * valid)[..., None]], -1)
        out[b0:b0 + rows] = p2p_plain(body[b0:b0 + rows, None, :dim], src,
                                      softening)[:, 0]
    return out


def near_field_occupied_cuda(tree, table: torch.Tensor,
                             softening: float) -> torch.Tensor:
    """The ring near field of every body of an occupied-cell tree
    (``sparse_grid.OccupiedTree``) in sorted-body order, not scaled by G:
    for each leaf, its bodies against the bodies of the leaves of its row
    of ``table`` (``sparse_grid.occupied_ring_table``). On CUDA tensors one
    K6 launch (computed in fp32, cast back to the tree's dtype), no
    read-back; on CPU tensors :func:`near_field_occupied_plain`."""
    if _device_kind(tree.body_pack, table) == "cpu":
        return near_field_occupied_plain(tree, table, softening)
    if tree.n >= 1 << 31:
        raise ValueError(f"near_field_occupied kernel: N = {tree.n} needs "
                         f"32-bit body indices")
    body4 = tree.body_pack.to(torch.float32).contiguous()
    table = table.to(torch.int64).contiguous()
    start = tree.leaf_start.to(torch.int64).contiguous()
    count = tree.leaf_count.to(torch.int64).contiguous()
    # The kernel's warp of global index w takes the target chunk w of the
    # leaves' 32-body chunks, found in their inclusive prefix sum.
    chunk_end = torch.cumsum((count + 31) // 32, 0)
    out = torch.empty((tree.n, tree.dim), dtype=torch.float32,
                      device=body4.device)
    code = cuda_build.load_library().nbody_near_field_occupied(
        body4.data_ptr(), table.data_ptr(), start.data_ptr(),
        count.data_ptr(), chunk_end.data_ptr(), out.data_ptr(), tree.dim,
        table.shape[0], table.shape[1], tree.n, float(softening) ** 2,
        _stream())
    cuda_build.check(code, "near_field_occupied kernel")
    LAUNCHES["near_field_occupied"] += 1
    return out.to(tree.pos_sorted.dtype)
