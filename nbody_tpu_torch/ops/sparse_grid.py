"""Sparse (clustered-input) grid evaluation: chunked targets and a windowed
near field, O(N) memory on any mass distribution.

Port of ``nbody_tpu.ops.sparse_grid``. The dense grid pads every leaf to
the max leaf occupancy, so its near field scales with capacity²; a
Plummer-style core (one cell holding most of the bodies) degenerates it and
``check_grid_capacity`` refuses the input. This tier keeps the same tree and
the same telescoping V-list far field, but:

* targets are cell-aligned chunks of at most ``chunk_size`` sorted bodies
  (``grid_tree.chunk_table``), so a dense cell contributes more chunks; all
  bodies of a chunk share one cell, hence one ring and one ancestor chain;
* near-field sources are windows of ``window`` bodies over the contiguous
  runs of the (2k+1)^D ring cells, evaluated in sub-batches that skip the
  empty ones: the work is the real ring occupancy, streamed through bounded
  [B, wl·window] tiles;
* the static sizes come from an exact probe (:func:`sparse_grid_stats`),
  so there is no overflow path;
* the leaf aggregates are chunk partial sums
  (``build_grid_tree(agg_num_chunks=)``).

What differs from the JAX package, and why:

* ``sparse_grid_stats`` has no id/weakref memo: torch tensors are mutable.
  Every call measures, with one device sync.
* The window tables are filled by one batched ``searchsorted`` over each
  chunk's ring-cell window offsets instead of a loop over the ring cells:
  the windows of one ring cell are contiguous and disjoint from the others',
  so both give the same integers.
* ``lax.cond`` over empty sub-batches becomes one reduction that finds the
  tiles with work, read back once a call, and a loop over those. A tile is
  one sub-batch of windows for a block of chunk rows (at most
  ``_TILE_ELEMS`` pair elements): a block skips the sub-batches that none
  of its chunks' rings reach (the JAX package skips a sub-batch only when
  no chunk of the batch has a window in it), and the target slots past its
  longest chunk.
* ``lax.map`` over chunk batches is a Python loop over the same batches;
  ``num_segments`` keeps the JAX package's padding of the batches to whole
  segments (its split bounds one TPU dispatch; here every segment's
  batches run in the one loop, so it changes no result). A batch
  evaluates only its real chunks, and only as many target slots as its
  longest chunk: the rows and slots it skips are never read.
* The near field here is plain torch, as it is plain ``jnp`` in the JAX
  package: no K6 launch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import DEFAULT_GRAVITY, GravityConfig
from .grid_tree import (GridTree, _clipped_ids, _in_bounds,
                        _neighbor_offsets, _point_mass_accel,
                        auto_leaf_level, build_grid_tree, cell_coords,
                        chunk_table, far_field_rings, theta_to_ring)
from .keys import morton_key_from_coords, quantize

# Bodies a block of the window-count probe (the JAX package's block).
_STATS_BLOCK = 16384
# Pair elements of one near-field tile [chunks, chunk, sources]: chunk rows
# are evaluated in blocks of at most this many (rows are independent, so
# the blocks change no result, only the temporaries' size).
_TILE_ELEMS = 1 << 25


def sparse_grid_stats(positions: torch.Tensor, leaf_level: int, chunk: int,
                      window: int, k: int):
    """(num_chunks, max_windows): the total of the cell-aligned chunks of
    ``chunk`` bodies, and the most ``window``-body source windows any
    occupied cell's (2k+1)^D ring holds; each at least 1. One device
    sync."""
    n, dim = positions.shape
    L = leaf_level
    ids = morton_key_from_coords(quantize(positions, L), L)
    counts = torch.bincount(ids, minlength=1 << (dim * L))
    num_chunks = (-(-counts // chunk)).sum()
    # Max over occupied cells == max over bodies (no unique() needed).
    wc = -(-counts // window)
    offs = torch.as_tensor(_neighbor_offsets(dim, k), device=ids.device)
    maxw = torch.zeros((), dtype=wc.dtype, device=ids.device)
    for b0 in range(0, n, _STATS_BLOCK):
        ids_b = ids[b0:b0 + _STATS_BLOCK]
        nb_xy = cell_coords(ids_b, dim)[:, None, :] + offs[None, :, :]
        nb_ids = _clipped_ids(nb_xy, L, dim, (ids_b.shape[0], -1))
        maxw = torch.maximum(
            maxw, (wc[nb_ids] * _in_bounds(nb_xy, L)).sum(1).max())
    nt, nw = torch.stack([num_chunks, maxw]).tolist()
    return max(1, int(nt)), max(1, int(nw))


def near_field_windows(tree: GridTree, cell_b: torch.Tensor,
                       tpos: torch.Tensor, *, k: int, window: int,
                       max_windows: int, softening: float,
                       tlen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ring near field of target chunks through fixed-size source windows.

    ``cell_b`` [B] is each chunk's leaf cell; its (2k+1)^D ring cells are
    contiguous runs of sorted bodies, each covered by ⌈occ/window⌉ windows,
    at most ``max_windows`` a chunk (:func:`sparse_grid_stats`). The
    [B, max_windows] window tables (first body, end of the run) are
    evaluated in sub-batches of windows, by blocks of chunk rows; a block
    skips the sub-batches where none of its chunks has a window, and with
    ``tlen`` [B] (each chunk's real targets) the target slots past its
    longest chunk. Self and coincident pairs fall to the always-on raw d² <
    1e-10 guard. Returns the increment for ``tpos`` [B, T, D] (zero in the
    slots skipped).
    """
    dim = tree.dim
    dev = tree.pos_sorted.device
    B = cell_b.shape[0]
    NW, S = max_windows, window
    offs = torch.as_tensor(_neighbor_offsets(dim, k), device=dev)
    nb_xy = cell_coords(cell_b, dim)[:, None, :] + offs[None, :, :]
    nb_ids = _clipped_ids(nb_xy, tree.leaf_level, dim, (B, -1))
    rs = tree.cell_start[nb_ids]  # [B, nnear]
    cnt = tree.cell_count[nb_ids] * _in_bounds(nb_xy, tree.leaf_level)
    wc = -(-cnt // S)
    wend_c = torch.cumsum(wc, dim=1)  # end of each ring cell's windows
    woff = wend_c - wc

    # Window slot w of a chunk belongs to the ring cell j with
    # woff[j] <= w < woff[j] + wc[j]; slots past the last are empty.
    wl = min(NW, max(1, 2048 // S))
    NWr = -(-NW // wl) * wl  # whole sub-batches: slices never run short
    warange = torch.arange(NWr, device=dev).expand(B, NWr).contiguous()
    j = torch.searchsorted(wend_c, warange, right=True)
    has = j < wend_c.shape[1]
    jc = j.clamp(max=wend_c.shape[1] - 1)
    rsj = torch.gather(rs, 1, jc)
    zero = torch.zeros_like(warange)
    wstart = torch.where(has, rsj + (warange - torch.gather(woff, 1, jc)) * S,
                         zero)
    wend = torch.where(has, rsj + torch.gather(cnt, 1, jc), zero)

    # Which (row block, sub-batch) tiles hold a window, and each block's
    # target slots: one read-back.
    T = tpos.shape[1]
    rb = max(1, _TILE_ELEMS // (T * wl * S))
    nwb, nrb = NWr // wl, -(-B // rb)
    has_w = F.pad((wend > wstart).reshape(B, nwb, wl).any(dim=2),
                  (0, 0, 0, nrb * rb - B)).reshape(nrb, rb, nwb).any(dim=1)
    tl = (torch.full((nrb,), T, device=dev) if tlen is None else
          F.pad(tlen, (0, nrb * rb - B)).reshape(nrb, rb).amax(dim=1))
    flat = torch.cat([has_w.T.flatten().to(tl.dtype), tl]).tolist()
    busy, tmax = flat[:nwb * nrb], flat[nwb * nrb:]
    arangeS = torch.arange(S, device=dev)
    bt = tree.body_pack.reshape(-1, 4)
    nrows = bt.shape[0]
    acc = torch.zeros(tpos.shape, dtype=tpos.dtype, device=dev)
    for c in range(nwb):
        for i in range(nrb):
            t = tmax[i]
            if not (busy[c * nrb + i] and t):
                continue
            r = slice(i * rb, (i + 1) * rb)
            ws = wstart[r, c * wl:(c + 1) * wl]
            idx = ws[:, :, None] + arangeS  # [rows, wl, S]
            src = bt[idx.clamp(0, nrows - 1)]
            smass = src[..., 3] * (idx < wend[r, c * wl:(c + 1) * wl, None])
            acc[r, :t] += _point_mass_accel(
                tpos[r, :t], src[..., :dim].reshape(idx.shape[0], -1, dim),
                smass.reshape(idx.shape[0], -1), softening)
    return acc


def barnes_hut_sparse(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    theta: Optional[float] = None,
    leaf_level: Optional[int] = None,
    # The JAX package's tune at Plummer 1e5 3D θ = 0.25 on its TPU
    # (artifacts/clustered_stress.json): larger cell-aligned chunks amortize
    # the per-chunk window tables over the core's huge cells.
    chunk_size: int = 512,
    window: int = 8,
    chunk_batch: int = 128,
    multipole: str = "quad",
    far_impl: str = "local",
    num_segments: Optional[int] = None,
) -> torch.Tensor:
    """Barnes-Hut forces [N, D] on the sparse grid: build, chunked
    evaluation, unsort, scale by G·m.

    The force law and ring MAC of ``grid_tree.barnes_hut_grid`` (θ_eff =
    1/(k+1) ≤ θ; quadrupole far field by default through
    ``far_field_rings``), with the near field of
    :func:`near_field_windows`. The sizes come from one
    :func:`sparse_grid_stats` probe. ``num_segments`` (default 1, and 4
    from N = 5e5) pads the chunk batches to whole segments, as the JAX
    package's split does.
    """
    n, dim = positions.shape
    dev = positions.device
    theta = config.theta if theta is None else theta
    k = theta_to_ring(theta)
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim, k=k)
    num_chunks, max_windows = sparse_grid_stats(
        positions, leaf_level, chunk_size, window, k)
    if num_segments is None:
        num_segments = 1 if n < 500_000 else 4
    C0 = chunk_size
    tree = build_grid_tree(positions, masses, leaf_level, capacity=8,
                           quad=(multipole == "quad"),
                           agg_num_chunks=num_chunks, agg_chunk_size=C0)
    cell, cstart, clen, coffs = chunk_table(
        tree.cell_start, tree.cell_count, chunk=C0, num_chunks=num_chunks)

    # Chunk rows padded to whole batches and whole segments (clen 0).
    NB = -(-(-(-num_chunks // chunk_batch)) // num_segments) * num_segments
    pad = NB * chunk_batch - num_chunks
    cell, cstart, clen = (torch.cat([x, x.new_zeros(pad)])
                          for x in (cell, cstart, clen))
    # Target slots a batch needs: its longest chunk (one sync for all).
    tmax = clen.reshape(NB, chunk_batch).amax(1).tolist()
    bt = tree.body_pack.reshape(-1, 4)
    arangeC = torch.arange(C0, device=dev)
    acc_flat = torch.zeros((NB * chunk_batch, C0, dim), dtype=positions.dtype,
                           device=dev)
    soft = float(config.softening)
    for b in range(NB):  # segments in order; batches of pad rows skipped
        T = tmax[b]
        if T == 0:
            continue
        sl = slice(b * chunk_batch, min((b + 1) * chunk_batch, num_chunks))
        cell_b = cell[sl]
        rows = bt[(cstart[sl, None] + arangeC[:T]).clamp(0, bt.shape[0] - 1)]
        tpos = rows[..., :dim]  # slots past a chunk's end are never read
        acc_flat[sl, :T] = far_field_rings(
            tree, cell_b, tpos, k=k, multipole=multipole, far_impl=far_impl)
        acc_flat[sl, :T] += near_field_windows(
            tree, cell_b, tpos, k=k, window=window, max_windows=max_windows,
            softening=soft, tlen=clen[sl])
    # Sorted body i sits at (its cell's chunk, slot): a gather.
    leaf = tree.leaf_ids
    within = torch.arange(n, device=dev) - tree.cell_start[leaf]
    idx_flat = (coffs[leaf] + within // C0) * C0 + within % C0
    acc_sorted = acc_flat.reshape(-1, dim)[idx_flat]
    acc = torch.empty_like(acc_sorted)
    acc[tree.order] = acc_sorted
    return (config.G * masses)[:, None] * acc
