"""Hierarchical order-3 Taylor far field for the grid Barnes-Hut tier.

Port of ``nbody_tpu.ops.hier_far``: the far field as the classical FMM
downward pass, specialised to monopole + quadrupole sources and an order-3
Taylor local expansion (``ops/local_expansion.py``). Every level's
candidate cells are gathered once per parent cell, shared by its 2^D
children:

  for level l = 2..L:
    gather each level-(l−1) parent's ring children ((2k+1)^D·2^D rows);
    per child parity, split the V-list by Chebyshev shell:
      shells ≥ c_min → accumulate (a0, J, H, K) at the child's centre;
      inner shells (k < c < c_min) → defer one level down (the child's
        children's centres), except at the leaf level, where they stay
        per body;
    L2L-shift the parent coefficients to the child centres and add.

The MAC geometry and the quadrupole truncation are those of the per-leaf
evaluation; only where each accepted cell's field is expanded changes.
The JAX package's ``lax.map`` over parent chunks is a Python loop over the
same chunks here.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .grid_tree import GridTree, _clipped_ids, _in_bounds, _ring_offsets, \
    cell_coords
from .local_expansion import (LOCAL_RATIO_DEFAULT, local_coeffs, num_coeffs,
                              num_coeffs3, shift_local)


def _par_vec(pm: int, dim: int) -> np.ndarray:
    """Morton child-parity index → per-axis {0,1} offsets (axis d's LSB is
    id bit dim−1−d, as in ``cell_coords``)."""
    return np.array([(pm >> (dim - 1 - d)) & 1 for d in range(dim)],
                    np.int64)


@functools.lru_cache(maxsize=None)
def _parity_shell_sel(dim: int, k: int, c_min: int):
    """Per-parity candidate splits of the ring-children table:
    (own[pm] — shells ≥ c_min, dfr[pm] — k < shell < c_min, (idx [2^D, md],
    valid [2^D, md]) — dfr padded to a rectangle)."""
    cands, _ = _ring_offsets(dim, k)
    own, dfr = [], []
    for pm in range(1 << dim):
        cheb = np.abs(cands - _par_vec(pm, dim)).max(axis=1)
        own.append(np.where(cheb >= c_min)[0].astype(np.int64))
        dfr.append(np.where((cheb > k) & (cheb < c_min))[0].astype(np.int64))
    md = max((len(s) for s in dfr), default=0)
    idx = np.zeros((1 << dim, md), np.int64)
    valid = np.zeros((1 << dim, md), np.float32)
    for pm, s in enumerate(dfr):
        idx[pm, :len(s)] = s
        valid[pm, :len(s)] = 1.0
    return own, dfr, (idx, valid)


def _c_min(dim: int, k: int, local_ratio: float) -> int:
    # Clamped to k+1: shells ≤ k are the near ring, owned by the P2P pass.
    return max(math.ceil(dim ** 0.5 / (2.0 * local_ratio)), k + 1)


@functools.lru_cache(maxsize=None)
def leaf_defer_tables(dim: int, k: int, local_ratio: Optional[float] = None):
    """Per-parity leaf-level deferred-shell offsets in leaf units:
    (offs [2^D, md, D], valid [2^D, md]) for a leaf of parity
    pm = leaf_id & (2^D − 1). Used by the traversal-side ``"gather"``
    mode."""
    if local_ratio is None:
        local_ratio = LOCAL_RATIO_DEFAULT
    _, _, (dfr_idx, dfr_valid) = _parity_shell_sel(
        dim, k, _c_min(dim, k, local_ratio))
    cands, _ = _ring_offsets(dim, k)
    nch, md = dfr_idx.shape
    offs = np.zeros((nch, md, dim), np.int64)
    for pm in range(nch):
        offs[pm] = cands[dfr_idx[pm]] - _par_vec(pm, dim)[None, :]
    return offs, dfr_valid


def _interleave(per_par, rows):
    """Stack per-parity outputs [P, ...] on axis 1 and flatten to
    child-major Morton order [rows, ·]."""
    return tuple(torch.stack([t[i] for t in per_par], dim=1)
                 .reshape(rows, per_par[0][i].shape[-1])
                 for i in range(len(per_par[0])))


def hier_far_coeffs(
    tree: GridTree,
    k: int,
    multipole: str = "quad",
    local_ratio: Optional[float] = None,
    chunk_budget: int = 16_000_000,
    defer: str = "pack",
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, Optional[torch.Tensor]]:
    """Run the downward sweep. Returns (coeffs, dfr_pack, dfr_quad):

    coeffs — (a0 [G, D], J [G, nj], H [G, nh], K [G, nk]) order-3 local
      expansions at every leaf centre (G leaves);
    dfr_pack — [G, md·(D+1)] flattened (com | mass) of each leaf's inner
      far shells (masses 0 out of bounds / padding), evaluated per body;
    dfr_quad — [G, md·nq] matching second moments, or None.

    Levels with more than ``chunk_budget`` parent × candidate rows are swept
    in power-of-two parent chunks. ``defer="gather"`` returns
    (coeffs, [G, 0], None): the caller gathers the leaf-level inner shells.
    """
    dim, L = tree.dim, tree.leaf_level
    dt, dev = tree.pos_sorted.dtype, tree.pos_sorted.device
    if local_ratio is None:
        local_ratio = LOCAL_RATIO_DEFAULT
    c_min = _c_min(dim, k, local_ratio)
    own_sel, dfr_sel, (dfr_idx, dfr_valid) = _parity_shell_sel(dim, k, c_min)
    cand_offs = torch.as_tensor(_ring_offsets(dim, k)[0], device=dev)
    nc = int(cand_offs.shape[0])
    nch = 1 << dim
    _, nj, nh = num_coeffs(dim)
    nk = num_coeffs3(dim)
    quad = multipole == "quad"
    par = [torch.as_tensor(_par_vec(pm, dim), dtype=dt, device=dev)
           for pm in range(nch)]
    own_t = [torch.as_tensor(s, device=dev) for s in own_sel]
    dfr_t = [torch.as_tensor(s, device=dev) for s in dfr_sel]

    coeffs = None  # (a0, J, H, K) at current-level cell centres
    pre = None  # deferred contributions awaiting the next level
    dfr_pack = dfr_quad = None
    md = dfr_idx.shape[1] if defer != "gather" else 0

    for l in range(2, L + 1):
        P = 1 << (dim * (l - 1))
        h_l = tree.cell_sizes[l].to(dt)

        def level_fn(pidx, _l=l, _coeffs=coeffs, _h=h_l):
            Pc = pidx.shape[0]
            parent_xy = cell_coords(pidx, dim)
            cand_xy = parent_xy[:, None, :] * 2 + cand_offs[None, :, :]
            in_b = _in_bounds(cand_xy, _l)
            cand_ids = _clipped_ids(cand_xy, _l, dim, (Pc, -1))
            cpack = tree.level_pack[_l][cand_ids]  # [Pc, nc, 4]
            cmass = cpack[..., 3] * in_b
            ccom = cpack[..., :dim]
            cquad = (tree.level_quad[_l][cand_ids] * in_b[..., None]
                     if quad else None)
            parent_center = tree.lo.to(dt) + (parent_xy.to(dt) + 0.5) \
                * tree.cell_sizes[_l - 1].to(dt)

            # Shells ≥ c_min at each child's own centre.
            per_par = []
            for pm in range(nch):
                child_center = parent_center + (par[pm] - 0.5) * _h
                sel = own_t[pm]
                per_par.append(local_coeffs(
                    child_center, ccom[:, sel], cmass[:, sel],
                    cquad[:, sel] if quad else None, order3=True))
            level_c = _interleave(per_par, Pc * nch)

            # L2L: shift the parent expansions to the child centres.
            if _coeffs is not None:
                prows = tuple(c[pidx] for c in _coeffs)
                shifted = [shift_local(*prows, (par[pm] - 0.5) * _h)
                           for pm in range(nch)]
                level_c = tuple(a + b for a, b in
                                zip(level_c, _interleave(shifted, Pc * nch)))

            # Inner far shells (k < cheb < c_min).
            if _l < L:
                if not any(s.size for s in dfr_sel):
                    return level_c
                # Deferred one level down, to the grandchild centres.
                h_next = tree.cell_sizes[_l + 1].to(dt)
                gc_offs = torch.stack([(par[pm2] - 0.5) * h_next
                                       for pm2 in range(nch)])  # [nch, D]
                pre_par = []
                for pm in range(nch):
                    sel = dfr_t[pm]
                    child_center = parent_center + (par[pm] - 0.5) * _h
                    gc_centers = child_center[:, None, :] + gc_offs[None]
                    pre_par.append(local_coeffs(
                        gc_centers, ccom[:, None, sel], cmass[:, None, sel],
                        cquad[:, None, sel] if quad else None, order3=True))
                return level_c + _interleave(pre_par, Pc * nch * nch)
            # Leaf level: the inner shells stay per body, flattened per
            # leaf in Morton order.
            if not md:
                return level_c
            packs, quads = [], []
            for pm in range(nch):
                sel = torch.as_tensor(dfr_idx[pm], device=dev)
                v = torch.as_tensor(dfr_valid[pm], dtype=dt, device=dev)
                packs.append(torch.cat(
                    [ccom[:, sel], (cmass[:, sel] * v)[..., None]], dim=-1))
                if quad:
                    quads.append(cquad[:, sel] * v[:, None])
            out = level_c + (torch.stack(packs, dim=1).reshape(
                Pc * nch, md * (dim + 1)),)
            if quad:
                out = out + (torch.stack(quads, dim=1).reshape(
                    Pc * nch, md * quads[0].shape[-1]),)
            return out

        all_pidx = torch.arange(P, device=dev)
        if P * nc <= chunk_budget or P < 2:
            outs = level_fn(all_pidx)
        else:
            chunk = max(1, chunk_budget // nc)
            chunk = min(P, 1 << (chunk.bit_length() - 1))  # pow2 divides P
            parts = [level_fn(c) for c in all_pidx.reshape(-1, chunk)]
            outs = tuple(torch.cat([p[i] for p in parts])
                         for i in range(len(parts[0])))

        level_c = outs[:4]
        if pre is not None:
            level_c = tuple(a + b for a, b in zip(level_c, pre))
        coeffs = level_c
        if l < L:
            pre = outs[4:8] if len(outs) > 4 else None
        elif md:
            dfr_pack = outs[4]
            if quad:
                dfr_quad = outs[5]

    G = tree.num_leaf_cells
    if coeffs is None:  # L < 2: no far field at all
        coeffs = tuple(torch.zeros((G, w), dtype=dt, device=dev)
                       for w in (dim, nj, nh, nk))
    if dfr_pack is None:
        dfr_pack = torch.zeros((G, 0), dtype=dt, device=dev)
    return coeffs, dfr_pack, dfr_quad
