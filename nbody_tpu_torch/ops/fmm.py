"""Fast Multipole Method: black-box (Chebyshev) FMM on the grid tree.

Port of ``nbody_tpu.ops.fmm``, the black-box FMM of Fong & Darve (J. Comp.
Phys. 228, 2009): cells carry weights at tensor Chebyshev nodes, so the
method expands exactly the suite's kernel K(x, y) = 1/|x − y| (a = G·∇φ) in
2D and 3D, and converges to the direct sum as the order n grows. Six
phases, each a dense batched product:

  P2M   anterpolate body masses onto leaf-cell Chebyshev nodes
  M2M   child → parent interpolation (2^D static [n^D, n^D] operators)
  M2L   per V-list offset δ: gather the source cells, multiply by K_δ
  L2L   parent → child (the transpose of M2M)
  L2P   gradient of the Chebyshev interpolant at each body
  P2P   the leaf near field over the (2k+1)^D neighbour cells

V-lists follow the grid tree's telescoping rings: per-level offsets whose
membership depends on a cell's parity in its parent, held as static
per-offset parity masks.

What differs from the JAX package, and why:

* ``_fmm_fused`` (jit fusion against relay latency) is the body of
  :func:`fmm_forces`; ``lax.map`` over leaf batches, chunk batches and L2P
  blocks is a Python loop over the same batches and blocks, without the
  JAX package's pad rows (they add nothing).
* M2L sums over offsets by chunks of offsets: the gathered source weights
  of a chunk are laid side by side along the feature axis and multiplied
  once against the stacked Kᵀ_δ, so the matmul does the sum over δ. Each
  gathered chunk is at most ``_M2L_GATHER_BYTES``. K is built once at leaf
  scale; a coarser level scales the product by 2^−(L−l), which is exact.
* The dense P2P is one call to ``grid_tree._near_field_accel`` over every
  leaf, which returns sorted order: under ``p2p_impl="auto"`` one launch of
  the hand-written kernel K6 (``ops/cuda_p2p.near_field_cuda``) for an fp32
  tree on the card, the plain near field in the tree's dtype otherwise;
  ``"cuda"`` is K6 in fp32, ``"plain"`` the windowed plain version. The
  JAX package's per-batch window gather and unscatter are not ported.
* The local side runs in float64 for an fp32 tree (the JAX package runs
  every phase in the tree's dtype): the operators Kᵀ_δ, M2L's products
  and sums over offsets (on the multipole weights cast to float64), L2L,
  and L2P (each body's position in its cell's frame, the Chebyshev basis
  and its gradient, the sum over the n^D nodes), cast to the tree's dtype
  where L2P writes a body's far field. L2P takes the gradient of the
  interpolated potential, and the potential of every V-list cell is
  nearly constant across a leaf, so it cancels: the terms L2P sums are up
  to ~1e4 times the force, and each fp32 rounding on the local side lands
  on the force at ~1e4 ulps. In fp32 the far field read 3.7e-3 of the RMS
  force at 4e6 3D order 8 (leaf level 5), against the 1e-4 of the direct
  sum that the FMM is run at. The multipole side has no such cancellation
  (sums of positive masses, an error that moves the potential smoothly
  across the target leaf), so P2M, M2M, the multipole weights and the
  near field stay in the tree's dtype. On an H100 float64 products run on
  the tensor cores at the rate of float32 on the CUDA cores (67 TFLOP/s).
  A float64 tree computes every phase in float64, as before.
* Accuracy-bearing products must not run in TF32: on CUDA tensors
  :func:`fmm_forces` and :func:`fmm_accel_sorted` raise while
  ``torch.backends.cuda.matmul.allow_tf32`` is on.
* ``compute_capacity_cached`` is dropped (torch tensors are mutable).
* Sharding: the JAX program runs under ``shard_map`` with two
  ``all_gather``s in its middle. One process runs it as stages over P
  shards (:func:`fmm_shard_partials`, the one code path; unsharded is P =
  1): P2M of each shard's leaf chunk, then gather; M2M once per device;
  M2L of each shard's cell rows at every level with at least P cells, then
  gather, the coarser levels once per device; L2L once per device; L2P and
  P2P of each shard's leaf chunk, its partial zero elsewhere. The caller
  adds the partials. ``fmm_accel_sorted(shard_index=r, num_shards=P)``
  returns shard r's partial of the same stages on one tree. L2P runs only
  over the shard's bodies, where the JAX program runs every body and
  zeroes the others.

Spans (:mod:`..utils.profiling`, off by default), on the tree's device:
``fmm.build`` (the capacity scan or ``sparse_grid_stats``, and
``build_grid_tree``), ``fmm.upward`` (P2M and M2M), ``fmm.m2l`` (M2L over
every level), ``fmm.downward`` (L2L and L2P), ``fmm.p2p`` (the near field);
counter ``fmm.reads``, each host read-back of a call (the capacity, the
sparse grid's sizes, each chunk batch's window table, a shard's body
range).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..utils.device_mesh import Mesh
from ..utils.profiling import count, span
from .grid_tree import (GridTree, _clipped_ids, _in_bounds, _near_field_accel,
                        _resolve_p2p_impl, _window_rows, auto_leaf_level,
                        build_grid_tree, cell_coords, check_grid_capacity,
                        chunk_table, compute_capacity,
                        dense_layout_degenerate, shard_leaves)

# The dtype of the local side (module docstring): K, M2L, L2L and L2P.
_LOCAL_DTYPE = torch.float64
# Bytes of one M2L chunk of gathered source weights [cells, chunk·n^D],
# in the local dtype.
_M2L_GATHER_BYTES = 1 << 30
# Sorted bodies an L2P block: each block gathers its own [blk, n^D] local
# weights, so the peak stays independent of N (the whole-array gather at
# 5e6 3D order 8 needed 19 GB of temporaries in the JAX package). A block
# is ~95 launches; at 65,536 bodies its float64 temporaries at order 8 in
# 3D stay near 1 GB, and the card, not the host's launches, sets L2P's
# pace (at 8,192, a 4e6-body call made ~46,500 launches, left the card
# idle 58% of a step, and its time swung 12% from run to run on an H100).
_L2P_BLOCK = 65536
# Elements of one dense P2M batch's basis [leaves, window rows, n^D]: 2 GiB
# in fp32. At the near field's 1,024 leaves a batch, P2M at 4e6 3D order 8
# took the host 75-90 ms of launches for 38 ms of the card's work, and the
# step swung 5% from run to run on an H100.
_P2M_ELEMS = 1 << 29


# --- Chebyshev machinery (static, numpy) -----------------------------------

def cheb_nodes(n: int) -> np.ndarray:
    """First-kind Chebyshev points in (-1, 1)."""
    m = np.arange(n)
    return np.cos((2 * m + 1) * np.pi / (2 * n))


def _cheb_T(n: int, y: np.ndarray) -> np.ndarray:
    """[T_0..T_{n-1}](y): shape (n, *y.shape)."""
    T = [np.ones_like(y), y]
    for k in range(2, n):
        T.append(2 * y * T[-1] - T[-2])
    return np.stack(T[:n])


def s_matrix(n: int, y: np.ndarray) -> np.ndarray:
    """Interpolation kernel S_n(t_m, y): shape (len(y), n) — row per y."""
    t = cheb_nodes(n)
    Tt = _cheb_T(n, t)  # (n, n)
    Ty = _cheb_T(n, np.asarray(y))  # (n, len(y))
    return (1.0 / n + (2.0 / n) * np.einsum("km,ky->ym", Tt[1:], Ty[1:]))


def m2m_operators(dim: int, n: int) -> np.ndarray:
    """[2^D, n^D, n^D]: child-octant weights → parent-node weights.

    M2M_o[m, m'] = Π_d S_n(t_{m,d}, (t_{m',d} + 2 o_d − 1)/2).
    """
    t = cheb_nodes(n)
    ops = []
    for octant in itertools.product((0, 1), repeat=dim):
        per_dim = []
        for d in range(dim):
            y = (t + 2 * octant[d] - 1) / 2.0  # child nodes in parent frame
            per_dim.append(s_matrix(n, y).T)  # (n, n): [m, m']
        op = per_dim[0]
        for d in range(1, dim):
            op = np.einsum("ab,cd->acbd", op, per_dim[d]).reshape(
                op.shape[0] * n, op.shape[1] * n)
        ops.append(op)
    return np.stack(ops)  # [2^D, n^D, n^D]


def _tensor_nodes(dim: int, n: int) -> np.ndarray:
    """All n^D tensor-product node coordinates in [-1,1]^D (Morton-major)."""
    t = cheb_nodes(n)
    grids = np.meshgrid(*([t] * dim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)  # [n^D, D]


def _v_list_deltas(dim: int, k: int):
    """Static V-list offsets at one level with parity masks.

    Returns list of (delta [D], parity_ok [D, 2] bool): cell c (parity q)
    interacts with cell c+delta iff cheb(delta) > k and the parents'
    offset floor((q+delta)/2) is within the parent near ring, per dim.
    """
    out = []
    rng = range(-(2 * k + 1), 2 * k + 2)
    for delta in itertools.product(rng, repeat=dim):
        if max(abs(x) for x in delta) <= k:
            continue  # near neighbor → P2P, not V-list
        parity_ok = np.zeros((dim, 2), dtype=bool)
        for d in range(dim):
            for q in (0, 1):
                # Parent offset along d for a cell with parity bit q.
                parity_ok[d, q] = abs(math.floor((q + delta[d]) / 2)) <= k
        # Keep the delta if some parity uses it (per-dim independence).
        if all(parity_ok[d].any() for d in range(dim)):
            out.append((np.array(delta, np.int32), parity_ok))
    return out


# --- Chebyshev recurrences on tensors ---------------------------------------

def _cheb_T_and_dT(n: int, y: torch.Tensor):
    """T_k(y) and T'_k(y) for k < n by recurrence: (..., n) each."""
    Ts = [torch.ones_like(y), y]
    dTs = [torch.zeros_like(y), torch.ones_like(y)]
    for k in range(2, n):
        Ts.append(2 * y * Ts[-1] - Ts[-2])
        dTs.append(2 * Ts[k - 1] + 2 * y * dTs[-1] - dTs[-2])
    return torch.stack(Ts[:n], -1), torch.stack(dTs[:n], -1)


def _interp_1d(n: int, y: torch.Tensor, Tt: torch.Tensor):
    """S_n(t_m, y): (..., n) over the nodes m; Tt [n, k] = T_k(t_m)."""
    Ty, _ = _cheb_T_and_dT(n, y)
    return 1.0 / n + (2.0 / n) * (Ty[..., 1:] @ Tt[:, 1:].T)


def _interp_and_grad_1d(n: int, y: torch.Tensor, Tt: torch.Tensor):
    """S_n(t_m, y) and its derivative in y: (..., n) each."""
    Ty, dTy = _cheb_T_and_dT(n, y)
    s = 1.0 / n + (2.0 / n) * (Ty[..., 1:] @ Tt[:, 1:].T)
    ds = (2.0 / n) * (dTy[..., 1:] @ Tt[:, 1:].T)
    return s, ds


def _outer_basis(factors):
    """Tensor-product basis [..., n^D] from per-dimension factors
    [(..., n)], dimension 0 slowest (the node order of
    :func:`_tensor_nodes`)."""
    basis = factors[0]
    for f in factors[1:]:
        basis = (basis[..., :, None] * f[..., None, :]).reshape(
            f.shape[:-1] + (-1,))
    return basis


@functools.lru_cache(maxsize=None)
def _device_tables(dim: int, order: int, dtype, device: torch.device):
    return (torch.as_tensor(_cheb_T(order, cheb_nodes(order)).T, dtype=dtype,
                            device=device),
            torch.as_tensor(m2m_operators(dim, order), dtype=dtype,
                            device=device))


def _tables(dim: int, order: int, dtype, device):
    """(Tt [n, k] = T_k(t_m), the M2M operators [2^D, n^D, n^D]) in
    ``dtype`` on ``device``: built once for each (dim, order, dtype,
    device) and shared by every caller, so read only: at order 8 in 3D
    the M2M operators take the host ~40 ms to build, and their copy to the
    card waits on its stream, which no evaluation should pay for."""
    return _device_tables(dim, order, dtype, torch.device(device))


def _side_tables(dim: int, order: int, dtype, device):
    """(Tt, M2M) of the multipole side (P2M, M2M) in the tree's ``dtype``,
    then (Tt, M2M) of the local side (L2L, L2P) in the local dtype."""
    return (_tables(dim, order, dtype, device)
            + _tables(dim, order, _LOCAL_DTYPE, device))


def _check_matmul_precision(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "fmm: the FMM's accuracy-bearing products need full-precision "
            "matmuls, and torch.backends.cuda.matmul.allow_tf32 is on (it "
            "would run them in TF32); set it to False")


# --- The phases --------------------------------------------------------------

def _leaf_half(tree: GridTree, dtype=None) -> torch.Tensor:
    return tree.cell_sizes[tree.leaf_level].to(dtype) / 2


def _cell_centers(tree: GridTree, cell_ids: torch.Tensor,
                  dtype=None) -> torch.Tensor:
    """Leaf-cell centres, in ``dtype`` (by default the tree's) from the
    tree's bounds."""
    dtype = dtype or tree.pos_sorted.dtype
    xy = cell_coords(cell_ids, tree.dim).to(dtype)
    return tree.lo.to(dtype) + (xy + 0.5) * tree.cell_sizes[
        tree.leaf_level].to(dtype)


def _anterpolate(pos, mass, valid, centers, half, order, Tt):
    """P2M of one batch: Σ over its rows of m · Π_d S_n(t_m, y_d) → [B, n^D].
    Masked rows are pinned to the cell centre (y = 0): a far row's T_k(y)
    can overflow, and 0·inf is NaN."""
    y = (pos - centers[:, None, :]) / half
    y = torch.where(valid[..., None], y, torch.zeros_like(y))
    s = _interp_1d(order, y, Tt)  # [B, C, D, n]
    basis = _outer_basis(s.unbind(-2))
    return torch.einsum("bc,bcm->bm", mass, basis)


def _p2m_dense(tree: GridTree, order: int, leaf_batch: int,
               Tt: torch.Tensor, leaf0: int = 0,
               nleaves: Optional[int] = None) -> torch.Tensor:
    """Node weights [nleaves, n^D] of leaves [leaf0, leaf0 + nleaves) (by
    default every leaf) from each leaf's contiguous run
    (``grid_tree._window_rows``), ``leaf_batch`` leaves at a time."""
    dim = tree.dim
    nl = tree.num_leaf_cells - leaf0 if nleaves is None else nleaves
    dev = tree.pos_sorted.device
    half = _leaf_half(tree)
    lb = min(leaf_batch, nl)
    out = tree.pos_sorted.new_empty((nl, order ** dim))
    for b0 in range(0, nl, lb):
        ids = torch.arange(leaf0 + b0, leaf0 + min(b0 + lb, nl), device=dev)
        tb, _, valid = _window_rows(tree, ids)  # [B, TWR, 4]
        out[b0:b0 + ids.numel()] = _anterpolate(
            tb[..., :dim], tb[..., 3] * valid, valid,
            _cell_centers(tree, ids), half, order, Tt)
    return out


def _p2m_batch(tree: GridTree, order: int) -> int:
    """Leaves a dense P2M batch: as many as keep its basis within
    ``_P2M_ELEMS`` elements."""
    rows = (tree.capacity // 8 + 1) * 8  # a leaf's window (_window_rows)
    return max(1, _P2M_ELEMS // (rows * order ** tree.dim))


def _sparse_chunks(tree: GridTree, num_chunks: int, chunk_size: int,
                   leaf_batch: int):
    """The sparse layout's cell-aligned body chunks, shared by P2M and P2P:
    (cell, cstart, clen, coffs, batch), taken in batches of ``batch =
    min(leaf_batch, 128, num_chunks)`` rows (the last one shorter: the JAX
    package's pad rows add nothing)."""
    return chunk_table(tree.cell_start, tree.cell_count, chunk=chunk_size,
                       num_chunks=num_chunks) + (
        min(leaf_batch, 128, num_chunks),)


def _chunk_rows(tree: GridTree, cstart_b, clen_b, chunk_size: int):
    """Packed rows [B, chunk, 4] of a batch of chunks and their mask."""
    bt = tree.body_pack.reshape(-1, 4)
    ar = torch.arange(chunk_size, device=bt.device)
    rows = bt[(cstart_b[:, None] + ar).clamp(0, bt.shape[0] - 1)]
    return rows, ar < clen_b[:, None]


def _p2m_sparse(tree: GridTree, order: int, chunks, chunk_size: int,
                Tt: torch.Tensor) -> torch.Tensor:
    """Leaf node weights from per-chunk partial weights added into the
    leaves: [B, chunk, n^D] temporaries, not capacity-padded ones."""
    cell, cstart, clen, _, cb = chunks
    dim, half = tree.dim, _leaf_half(tree)
    parts = []
    for b0 in range(0, cell.numel(), cb):
        sl = slice(b0, b0 + cb)
        rows, valid = _chunk_rows(tree, cstart[sl], clen[sl], chunk_size)
        parts.append(_anterpolate(rows[..., :dim], rows[..., 3] * valid,
                                  valid, _cell_centers(tree, cell[sl]),
                                  half, order, Tt))
    W = tree.pos_sorted.new_zeros((tree.num_leaf_cells, order ** dim))
    return W.index_add_(0, cell, torch.cat(parts))


def _m2m(W_leaf: torch.Tensor, m2m: torch.Tensor, dim: int, L: int) -> dict:
    """Upward sweep: node weights of every level 2..L."""
    W = {L: W_leaf}
    for l in range(L - 1, 1, -1):
        child = W[l + 1].reshape(-1, 1 << dim, W_leaf.shape[1])
        W[l] = torch.einsum("pon,omn->pm", child, m2m)
    return W


@functools.lru_cache(maxsize=None)
def _v_list_tables(dim: int, k: int, order: int, device: torch.device):
    """M2L's static tables on ``device``: (offsets [nd, D] int64, per-offset
    parity masks [nd, D, 2], the offsets and the tensor nodes [n^D, D] in
    the local dtype). Built once for each (dim, k, order, device) and
    shared by every caller, so read only: a copy from the host would wait
    on the device's stream in every evaluation."""
    deltas = _v_list_deltas(dim, k)
    dl = torch.as_tensor(np.stack([d for d, _ in deltas]),
                         device=device).to(torch.int64)
    par_ok = torch.as_tensor(np.stack([p for _, p in deltas]), device=device)
    nodes = torch.as_tensor(_tensor_nodes(dim, order), dtype=_LOCAL_DTYPE,
                            device=device)
    return dl, par_ok, dl.to(_LOCAL_DTYPE), nodes


def _m2l_kernel_t(tree: GridTree, dl: torch.Tensor,
                  nodes: torch.Tensor) -> torch.Tensor:
    """Stacked Kᵀ at leaf scale in the dtype of ``nodes``, [nd·n^D, n^D]
    for the offsets ``dl`` [nd, D]: row (δ, n), column m is
    1/|δ·h + t_n·h/2 − t_m·h/2| (source node n, target node m)."""
    dim = tree.dim
    cs = tree.cell_sizes[tree.leaf_level].to(nodes.dtype)
    half = cs / 2
    d2 = None
    for d in range(dim):
        diff = ((dl[:, d, None, None] * cs[d]
                 + nodes[None, :, None, d] * half[d])
                - nodes[None, None, :, d] * half[d])  # [nd, n^D, n^D]
        d2 = diff.mul_(diff) if d2 is None else d2.add_(diff.mul_(diff))
        del diff
    return d2.sqrt_().reciprocal_().reshape(-1, nodes.shape[0])


def _m2l_operators(tree: GridTree, order: int, k: int):
    """(offsets [nd, D], per-offset parity masks [nd, D, 2], stacked Kᵀ)
    of M2L, on the tree's device."""
    dl, par_ok, dl_local, nodes = _v_list_tables(
        tree.dim, k, order, tree.pos_sorted.device)
    return dl, par_ok, _m2l_kernel_t(tree, dl_local, nodes)


def _m2l_level(tree: GridTree, w_l: torch.Tensor, ops, l: int,
               row0: int = 0, nrows: Optional[int] = None) -> torch.Tensor:
    """Level l's V-list transfers into cell rows [row0, row0 + nrows) (by
    default every cell): local weights [nrows, n^D] in K's dtype (the
    multipole weights cast to it), not yet passed down."""
    dim, L = tree.dim, tree.leaf_level
    dl, par_ok, KT = ops
    w_l = w_l.to(KT.dtype)
    nD = w_l.shape[1]
    ncells = (1 << (dim * l)) - row0 if nrows is None else nrows
    xy = cell_coords(torch.arange(row0, row0 + ncells, device=w_l.device),
                     dim)
    parity = xy & 1
    acc = w_l.new_zeros((ncells, nD))
    nd = dl.shape[0]
    step = max(1, min(nd, _M2L_GATHER_BYTES
                      // (ncells * nD * KT.element_size())))
    for j0 in range(0, nd, step):
        j1 = min(j0 + step, nd)
        src_xy = xy[:, None, :] + dl[None, j0:j1, :]  # [cells, c, D]
        ok = _in_bounds(src_xy, l)
        for d in range(dim):
            ok &= par_ok[j0:j1, d, :].T[parity[:, d]]
        g = w_l[_clipped_ids(src_xy, l, dim, (ncells, -1))]
        g.mul_(ok[..., None])
        acc += g.reshape(ncells, -1) @ KT[j0 * nD:j1 * nD]
        del g
    return acc.mul_(2.0 ** -(L - l))  # K_l = K_L·2^-(L-l), exact


def _m2l(tree: GridTree, W: dict, order: int, k: int) -> dict:
    """V-list transfers: local weights [cells_l, n^D] of every level 2..L,
    not yet passed down (:func:`_l2l`)."""
    if tree.leaf_level < 2:
        return {}
    ops = _m2l_operators(tree, order, k)
    return {l: _m2l_level(tree, W[l], ops, l)
            for l in range(2, tree.leaf_level + 1)}


def _l2l(Lc: dict, m2m: torch.Tensor, L: int, nl: int) -> torch.Tensor:
    """Downward sweep: the leaf local weights [num_leaves, n^D], with the
    M2M operators ``m2m`` in the local dtype (transposed: L2L)."""
    if L < 2:
        return m2m.new_zeros((nl, m2m.shape[1]))
    for l in range(2, L):
        down = torch.einsum("pm,omn->pon", Lc[l], m2m)
        Lc[l + 1] = Lc[l + 1] + down.reshape(-1, m2m.shape[1])
    return Lc[L]


def _l2p(tree: GridTree, L_leaf: torch.Tensor, order: int,
         Tt: torch.Tensor, b0: int = 0,
         b1: Optional[int] = None) -> torch.Tensor:
    """Far-field accelerations [b1 − b0, D] of sorted bodies [b0, b1) (by
    default all): the gradient of the leaf interpolant, in blocks of
    ``_L2P_BLOCK`` bodies, computed in the dtype of the local weights
    ``L_leaf`` and of ``Tt``, written in the tree's."""
    dim, ldt = tree.dim, L_leaf.dtype
    b1 = tree.n if b1 is None else b1
    half = _leaf_half(tree, ldt)
    centers = _cell_centers(tree, torch.arange(tree.num_leaf_cells,
                                               device=L_leaf.device), ldt)
    out = tree.pos_sorted.new_empty((b1 - b0, dim))
    for i0 in range(b0, b1, _L2P_BLOCK):
        sl = slice(i0, min(i0 + _L2P_BLOCK, b1))
        body_leaf = tree.leaf_ids[sl]
        lw = L_leaf[body_leaf]  # [B, n^D]
        y = (tree.pos_sorted[sl].to(ldt) - centers[body_leaf]) / half
        s, ds = _interp_and_grad_1d(order, y, Tt)  # [B, D, n]
        s, ds = s.unbind(1), ds.unbind(1)
        out[i0 - b0:sl.stop - b0] = torch.stack([
            (_outer_basis([ds[d2] if d2 == d else s[d2]
                           for d2 in range(dim)]) * lw).sum(-1) / half[d]
            for d in range(dim)], dim=-1)
    return out


def _near_sparse(tree: GridTree, chunks, chunk_size: int, k: int,
                 window: int, max_windows: int,
                 softening: float) -> torch.Tensor:
    """Sparse P2P: each chunk batch's windowed ring near field, gathered
    back to sorted order."""
    from .sparse_grid import near_field_windows
    cell, cstart, clen, coffs, cb = chunks
    dim = tree.dim
    accs = []
    for b0 in range(0, cell.numel(), cb):
        sl = slice(b0, b0 + cb)
        rows, _ = _chunk_rows(tree, cstart[sl], clen[sl], chunk_size)
        count("fmm.reads")  # the batch's window table
        accs.append(near_field_windows(
            tree, cell[sl], rows[..., :dim], k=k, window=window,
            max_windows=max_windows, softening=softening, tlen=clen[sl]))
    leaf = tree.leaf_ids
    within = torch.arange(tree.n, device=leaf.device) - tree.cell_start[leaf]
    idx = (coffs[leaf] + within // chunk_size) * chunk_size \
        + within % chunk_size
    return torch.cat(accs).reshape(-1, dim)[idx]


def _leaf_bodies(tree: GridTree, leaf0: int, nleaves: int):
    """Sorted-body range [b0, b1) of leaves [leaf0, leaf0 + nleaves)."""
    if leaf0 == 0 and nleaves == tree.num_leaf_cells:
        return 0, tree.n
    last = leaf0 + nleaves - 1
    count("fmm.reads")
    b0, b1 = torch.stack([tree.cell_start[leaf0], tree.cell_start[last]
                          + tree.cell_count[last]]).tolist()
    return int(b0), int(b1)


def fmm_shard_partials(trees, mesh: Optional[Mesh] = None, order: int = 5,
                       ring: int = 1, softening: float = 0.0,
                       leaf_batch: int = 1024, p2p_impl: str = "plain",
                       _debug_skip: str = "", shards=None,
                       num_chunks: Optional[int] = None,
                       chunk_size: int = 64, window: int = 8,
                       max_windows: int = 0) -> list:
    """The FMM's stages over the P shards of ``mesh`` (module docstring;
    default: P = ``len(trees)`` virtual shards of the tree's device):
    ``trees[r]`` is shard r's copy of one tree on its device, shared by the
    shards of that device (``Mesh.replicate``). Returns the partials [N, D]
    of the shards in ``shards`` (default all), each on its shard's device
    and zero outside its leaf chunk; their sum is the evaluation."""
    tree = trees[0]
    dev = tree.pos_sorted.device
    if mesh is None:
        mesh = Mesh((dev,) * len(trees))
    p = mesh.num_shards
    dim, L, nl = tree.dim, tree.leaf_level, tree.num_leaf_cells
    dt = tree.pos_sorted.dtype
    _check_matmul_precision(tree.pos_sorted)
    sparse = num_chunks is not None
    if sparse and p > 1:
        raise ValueError("the sparse FMM layout is single-device; shard a "
                         "clustered input another way")
    shards = range(p) if shards is None else shards
    spans = [shard_leaves(nl, r if p > 1 else None, p) for r in range(p)]

    # P2M of each shard's leaf chunk, then gather; M2M once per device.
    with span("fmm.upward", dev):
        tables = mesh.per_device(lambda r: _side_tables(
            dim, order, dt, trees[r].pos_sorted.device))
        if sparse:
            chunks = _sparse_chunks(tree, num_chunks, chunk_size, leaf_batch)
            W_leaf = [_p2m_sparse(tree, order, chunks, chunk_size,
                                  tables[0][0])]
        else:
            W_leaf = mesh.all_gather(mesh.per_shard(lambda r: _p2m_dense(
                trees[r], order, _p2m_batch(tree, order), tables[r][0],
                *spans[r])))
        W = mesh.per_device(lambda r: _m2m(W_leaf[r], tables[r][1], dim, L))

    # M2L: a level of at least P cells by each shard's rows, then gather;
    # the coarser levels once per device.
    Lc = [dict() for _ in range(p)]
    if L >= 2 and "m2l" in _debug_skip:
        for r in range(p):
            Lc[r] = {l: W[r][l].new_zeros(W[r][l].shape, dtype=_LOCAL_DTYPE)
                     for l in range(2, L + 1)}
    elif L >= 2:
        with span("fmm.m2l", dev):
            ops = mesh.per_device(lambda r: _m2l_operators(trees[r], order,
                                                           ring))
            for l in range(2, L + 1):
                ncells = 1 << (dim * l)
                if p > 1 and ncells >= p:
                    mc = ncells // p
                    rows = mesh.all_gather(mesh.per_shard(
                        lambda r: _m2l_level(trees[r], W[r][l], ops[r], l,
                                             r * mc, mc)))
                else:
                    rows = mesh.per_device(lambda r: _m2l_level(
                        trees[r], W[r][l], ops[r], l))
                for r in range(p):
                    Lc[r][l] = rows[r]

    # L2L once per device; L2P and P2P of each shard's leaf chunk.
    with span("fmm.downward", dev):
        L_leaf = mesh.per_device(lambda r: _l2l(Lc[r], tables[r][3], L, nl))
    out = []
    for r in shards:
        t, (leaf0, ml) = trees[r], spans[r]
        tdev = t.pos_sorted.device
        with mesh.device_context(r):
            with span("fmm.downward", tdev):
                if "l2p" in _debug_skip:
                    acc = t.pos_sorted.new_zeros((t.n, dim))
                else:
                    b0, b1 = _leaf_bodies(t, leaf0, ml)
                    acc = _l2p(t, L_leaf[r], order, tables[r][2], b0, b1)
                    if b1 - b0 < t.n:  # zero rows around the shard's bodies
                        acc = torch.nn.functional.pad(
                            acc, (0, 0, b0, t.n - b1))
            with span("fmm.p2p", tdev):
                if "p2p" not in _debug_skip and sparse:
                    acc = acc + _near_sparse(t, chunks, chunk_size, ring,
                                             window, max_windows, softening)
                elif "p2p" not in _debug_skip:
                    acc = acc + _near_field_accel(
                        t, ring, softening,
                        _resolve_p2p_impl(p2p_impl, tdev),
                        leaf0, ml, leaf_batch)
        out.append(acc)
    return out


def fmm_accel_sorted(tree: GridTree, order: int = 5, ring: int = 1,
                     softening: float = 0.0, leaf_batch: int = 1024,
                     shard_index: Optional[int] = None, num_shards: int = 1,
                     p2p_impl: str = "plain", _debug_skip: str = "",
                     num_chunks: Optional[int] = None, chunk_size: int = 64,
                     window: int = 8, max_windows: int = 0) -> torch.Tensor:
    """FMM accelerations [N, D] of the sorted bodies, not G-scaled.

    ``p2p_impl`` selects the dense near field (see the module docstring).
    ``num_chunks`` switches P2M and P2P to the sparse (clustered-input)
    layout of ``ops/sparse_grid.py``: targets are cell-aligned chunks of
    ``chunk_size`` bodies and P2P sources are ``window``-body windows over
    the ring runs (``max_windows`` of them at most), so no tensor scales
    with the max leaf occupancy; M2M, M2L, L2L and L2P are unchanged. It is
    single-device. With ``num_shards`` > 1 the call returns shard
    ``shard_index``'s partial (:func:`fmm_shard_partials` on this one tree:
    P2M and M2L of every shard, L2P and P2P of this one's leaf chunk). Each
    such call recomputes every shard's P2M and M2L, so P calls for the P
    shards do those stages P times: to evaluate every shard, call
    :func:`fmm_shard_partials` (as ``parallel.fmm_sharded`` does).
    ``_debug_skip`` containing ``"m2l"``, ``"l2p"`` or ``"p2p"`` skips that
    phase (phase timing).
    """
    shard_leaves(tree.num_leaf_cells, shard_index, num_shards)  # checks
    return fmm_shard_partials(
        [tree] * num_shards, order=order, ring=ring, softening=softening,
        leaf_batch=leaf_batch, p2p_impl=p2p_impl, _debug_skip=_debug_skip,
        shards=[shard_index or 0], num_chunks=num_chunks,
        chunk_size=chunk_size, window=window, max_windows=max_windows)[0]


def fmm_forces(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    order: int = 5,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    ring: int = 1,
    leaf_batch: int = 1024,
    p2p_impl: str = "auto",
    layout: str = "auto",
) -> torch.Tensor:
    """Per-body forces [N, D] by black-box FMM: build, six phases, unsort,
    scale by G·m. Counterpart of ``nbody_tpu.ops.fmm.fmm_forces`` with the
    same parameters and defaults; the order is a static shape.

    ``p2p_impl``: ``"auto"`` (K6 for fp32 bodies on the card, else the plain
    near field in the bodies' dtype), ``"cuda"`` (K6 in fp32 on any dtype)
    or ``"plain"``. ``layout``: ``"dense"`` (capacity-padded P2M and P2P;
    refuses a degenerate capacity), ``"sparse"`` (chunked targets and a
    windowed plain near field, O(N) memory on any distribution) or
    ``"auto"``: dense, and sparse where the capacity guard would trip.
    """
    n, dim = positions.shape
    if layout not in ("auto", "dense", "sparse"):
        raise ValueError(f"layout must be 'auto', 'dense' or 'sparse', "
                         f"got {layout!r}")
    if dim == 3 and n >= 5_000_000:
        # The JAX package's batch for its TPU compiler at 5e6 3D, kept for
        # parity.
        leaf_batch = min(leaf_batch, 256)
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim)
    sparse = layout == "sparse"
    soft = float(config.softening)
    with span("fmm.build", positions.device):
        if capacity is None and not sparse:
            count("fmm.reads")
            capacity = compute_capacity(positions, leaf_level)
            if layout == "auto" and dense_layout_degenerate(
                    capacity, n, leaf_level, dim):
                sparse = True
            else:
                check_grid_capacity(capacity, n, leaf_level, dim,
                                    "fmm_forces")
        if sparse:
            from .sparse_grid import sparse_grid_stats
            chunk_size, window = 64, 8
            count("fmm.reads")
            num_chunks, max_windows = sparse_grid_stats(
                positions, leaf_level, chunk_size, window, ring)
            tree = build_grid_tree(positions, masses, leaf_level, 8,
                                   agg_num_chunks=num_chunks,
                                   agg_chunk_size=chunk_size)
        else:
            p2p_impl = _resolve_p2p_impl(p2p_impl, positions.device)
            tree = build_grid_tree(positions, masses, leaf_level, capacity)
    if sparse:
        acc_sorted = fmm_accel_sorted(
            tree, order=order, ring=ring, softening=soft,
            leaf_batch=leaf_batch, num_chunks=num_chunks,
            chunk_size=chunk_size, window=window, max_windows=max_windows)
    else:
        acc_sorted = fmm_accel_sorted(
            tree, order=order, ring=ring, softening=soft,
            leaf_batch=leaf_batch, p2p_impl=p2p_impl)
    acc = torch.empty_like(acc_sorted)
    acc[tree.order] = acc_sorted
    return (config.G * masses)[:, None] * acc
