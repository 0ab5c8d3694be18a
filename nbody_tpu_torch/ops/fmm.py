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
* Accuracy-bearing products must not run in TF32: on CUDA tensors
  :func:`fmm_forces` and :func:`fmm_accel_sorted` raise while
  ``torch.backends.cuda.matmul.allow_tf32`` is on.
* ``compute_capacity_cached`` is dropped (torch tensors are mutable); the
  sharded evaluation (``shard_axis``) is not ported yet (ROADMAP queue 1
  item 12).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from .grid_tree import (GridTree, _clipped_ids, _in_bounds, _near_field_accel,
                        _resolve_p2p_impl, _window_rows, auto_leaf_level,
                        build_grid_tree, cell_coords, check_grid_capacity,
                        chunk_table, compute_capacity,
                        dense_layout_degenerate)

# Bytes of one M2L chunk of gathered source weights [cells, chunk·n^D].
_M2L_GATHER_BYTES = 1 << 30
# Sorted bodies an L2P block: each block gathers its own [blk, n^D] local
# weights, so the peak stays independent of N (the whole-array gather at
# 5e6 3D order 8 needed 19 GB of temporaries in the JAX package).
_L2P_BLOCK = 8192


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


def _tables(dim: int, order: int, dtype, device):
    """(Tt [n, k] = T_k(t_m), the M2M operators [2^D, n^D, n^D])."""
    return (torch.as_tensor(_cheb_T(order, cheb_nodes(order)).T, dtype=dtype,
                            device=device),
            torch.as_tensor(m2m_operators(dim, order), dtype=dtype,
                            device=device))


def _check_matmul_precision(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "fmm: the FMM's accuracy-bearing products need full-precision "
            "matmuls, and torch.backends.cuda.matmul.allow_tf32 is on (it "
            "would run them in TF32); set it to False")


# --- The phases --------------------------------------------------------------

def _leaf_half(tree: GridTree) -> torch.Tensor:
    return tree.cell_sizes[tree.leaf_level] / 2


def _cell_centers(tree: GridTree, cell_ids: torch.Tensor) -> torch.Tensor:
    xy = cell_coords(cell_ids, tree.dim).to(tree.pos_sorted.dtype)
    return tree.lo + (xy + 0.5) * tree.cell_sizes[tree.leaf_level]


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
               Tt: torch.Tensor) -> torch.Tensor:
    """Leaf node weights [num_leaves, n^D] from each leaf's contiguous run
    (``grid_tree._window_rows``), ``leaf_batch`` leaves at a time."""
    dim, nl = tree.dim, tree.num_leaf_cells
    dev = tree.pos_sorted.device
    half = _leaf_half(tree)
    lb = min(leaf_batch, nl)
    out = tree.pos_sorted.new_empty((nl, order ** dim))
    for b0 in range(0, nl, lb):
        ids = torch.arange(b0, min(b0 + lb, nl), device=dev)
        tb, _, valid = _window_rows(tree, ids)  # [B, TWR, 4]
        out[b0:b0 + ids.numel()] = _anterpolate(
            tb[..., :dim], tb[..., 3] * valid, valid,
            _cell_centers(tree, ids), half, order, Tt)
    return out


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


def _m2l_kernel_t(tree: GridTree, order: int, deltas) -> torch.Tensor:
    """Stacked Kᵀ at leaf scale, [ndeltas·n^D, n^D]: row (δ, n), column m
    is 1/|δ·h + t_n·h/2 − t_m·h/2| (source node n, target node m)."""
    dim, dt = tree.dim, tree.pos_sorted.dtype
    dev = tree.pos_sorted.device
    nodes = torch.as_tensor(_tensor_nodes(dim, order), dtype=dt, device=dev)
    dl = torch.as_tensor(np.stack([d for d, _ in deltas]), device=dev).to(dt)
    cs = tree.cell_sizes[tree.leaf_level]
    half = cs / 2
    d2 = None
    for d in range(dim):
        diff = ((dl[:, d, None, None] * cs[d]
                 + nodes[None, :, None, d] * half[d])
                - nodes[None, None, :, d] * half[d])  # [nd, n^D, n^D]
        d2 = diff.mul_(diff) if d2 is None else d2.add_(diff.mul_(diff))
        del diff
    return d2.sqrt_().reciprocal_().reshape(-1, nodes.shape[0])


def _m2l(tree: GridTree, W: dict, order: int, k: int) -> dict:
    """V-list transfers: local weights [cells_l, n^D] of every level 2..L,
    not yet passed down (:func:`_l2l`)."""
    dim, L = tree.dim, tree.leaf_level
    dev = tree.pos_sorted.device
    nD = order ** dim
    if L < 2:
        return {}
    deltas = _v_list_deltas(dim, k)
    dl = torch.as_tensor(np.stack([d for d, _ in deltas]), device=dev)\
        .to(torch.int64)
    par_ok = torch.as_tensor(np.stack([p for _, p in deltas]), device=dev)
    KT = _m2l_kernel_t(tree, order, deltas)
    elsize = KT.element_size()
    Lc = {}
    for l in range(2, L + 1):
        ncells = 1 << (dim * l)
        xy = cell_coords(torch.arange(ncells, device=dev), dim)
        parity = xy & 1
        w_l = W[l]
        acc = w_l.new_zeros((ncells, nD))
        step = max(1, min(len(deltas),
                          _M2L_GATHER_BYTES // (ncells * nD * elsize)))
        for j0 in range(0, len(deltas), step):
            j1 = min(j0 + step, len(deltas))
            src_xy = xy[:, None, :] + dl[None, j0:j1, :]  # [cells, c, D]
            ok = _in_bounds(src_xy, l)
            for d in range(dim):
                ok &= par_ok[j0:j1, d, :].T[parity[:, d]]
            g = w_l[_clipped_ids(src_xy, l, dim, (ncells, -1))]
            g.mul_(ok[..., None])
            acc += g.reshape(ncells, -1) @ KT[j0 * nD:j1 * nD]
            del g
        Lc[l] = acc.mul_(2.0 ** -(L - l))  # K_l = K_L·2^-(L-l), exact
    return Lc


def _l2l(Lc: dict, m2m: torch.Tensor, L: int, nl: int,
         like: torch.Tensor) -> torch.Tensor:
    """Downward sweep: the leaf local weights [num_leaves, n^D]."""
    if L < 2:
        return like.new_zeros((nl, m2m.shape[1]))
    for l in range(2, L):
        down = torch.einsum("pm,omn->pon", Lc[l], m2m)
        Lc[l + 1] = Lc[l + 1] + down.reshape(-1, m2m.shape[1])
    return Lc[L]


def _l2p(tree: GridTree, L_leaf: torch.Tensor, order: int,
         Tt: torch.Tensor) -> torch.Tensor:
    """Far-field accelerations [N, D] of the sorted bodies: the gradient of
    the leaf interpolant, in blocks of ``_L2P_BLOCK`` bodies."""
    dim, n = tree.dim, tree.n
    half = _leaf_half(tree)
    centers = _cell_centers(tree, torch.arange(tree.num_leaf_cells,
                                               device=L_leaf.device))
    out = tree.pos_sorted.new_empty((n, dim))
    for b0 in range(0, n, _L2P_BLOCK):
        sl = slice(b0, b0 + _L2P_BLOCK)
        body_leaf = tree.leaf_ids[sl]
        lw = L_leaf[body_leaf]  # [B, n^D]
        y = (tree.pos_sorted[sl] - centers[body_leaf]) / half
        s, ds = _interp_and_grad_1d(order, y, Tt)  # [B, D, n]
        s, ds = s.unbind(1), ds.unbind(1)
        out[sl] = torch.stack([
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
        accs.append(near_field_windows(
            tree, cell[sl], rows[..., :dim], k=k, window=window,
            max_windows=max_windows, softening=softening, tlen=clen[sl]))
    leaf = tree.leaf_ids
    within = torch.arange(tree.n, device=leaf.device) - tree.cell_start[leaf]
    idx = (coffs[leaf] + within // chunk_size) * chunk_size \
        + within % chunk_size
    return torch.cat(accs).reshape(-1, dim)[idx]


def fmm_accel_sorted(tree: GridTree, order: int = 5, ring: int = 1,
                     softening: float = 0.0, leaf_batch: int = 1024,
                     shard_axis: Optional[str] = None,
                     p2p_impl: str = "plain", _debug_skip: str = "",
                     num_chunks: Optional[int] = None, chunk_size: int = 64,
                     window: int = 8, max_windows: int = 0) -> torch.Tensor:
    """FMM accelerations [N, D] of the sorted bodies, not G-scaled.

    ``p2p_impl`` selects the dense near field (see the module docstring).
    ``num_chunks`` switches P2M and P2P to the sparse (clustered-input)
    layout of ``ops/sparse_grid.py``: targets are cell-aligned chunks of
    ``chunk_size`` bodies and P2P sources are ``window``-body windows over
    the ring runs (``max_windows`` of them at most), so no tensor scales
    with the max leaf occupancy; M2M, M2L, L2L and L2P are unchanged.
    ``_debug_skip`` containing ``"m2l"``, ``"l2p"`` or ``"p2p"`` skips that
    phase (phase timing).
    """
    if shard_axis is not None:
        raise NotImplementedError(
            "fmm_accel_sorted(shard_axis=...): the sharded FMM is not ported "
            "to PyTorch yet (ROADMAP queue 1 item 12)")
    _check_matmul_precision(tree.pos_sorted)
    dim, L = tree.dim, tree.leaf_level
    dt, dev = tree.pos_sorted.dtype, tree.pos_sorted.device
    Tt, m2m = _tables(dim, order, dt, dev)
    sparse = num_chunks is not None
    if sparse:
        chunks = _sparse_chunks(tree, num_chunks, chunk_size, leaf_batch)
        W_leaf = _p2m_sparse(tree, order, chunks, chunk_size, Tt)
    else:
        W_leaf = _p2m_dense(tree, order, leaf_batch, Tt)
    W = _m2m(W_leaf, m2m, dim, L)
    if "m2l" in _debug_skip:
        Lc = {l: W[l].new_zeros(W[l].shape) for l in range(2, L + 1)}
    else:
        Lc = _m2l(tree, W, order, ring)
    L_leaf = _l2l(Lc, m2m, L, tree.num_leaf_cells, W_leaf)
    if "l2p" in _debug_skip:
        acc = tree.pos_sorted.new_zeros((tree.n, dim))
    else:
        acc = _l2p(tree, L_leaf, order, Tt)
    if "p2p" in _debug_skip:
        return acc
    if sparse:
        return acc + _near_sparse(tree, chunks, chunk_size, ring, window,
                                  max_windows, softening)
    p2p_impl = _resolve_p2p_impl(p2p_impl, dev)
    return acc + _near_field_accel(tree, ring, softening, p2p_impl, 0,
                                   tree.num_leaf_cells, leaf_batch)


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
    if capacity is None and not sparse:
        capacity = compute_capacity(positions, leaf_level)
        if layout == "auto" and dense_layout_degenerate(
                capacity, n, leaf_level, dim):
            sparse = True
        else:
            check_grid_capacity(capacity, n, leaf_level, dim, "fmm_forces")
    soft = float(config.softening)
    if sparse:
        from .sparse_grid import sparse_grid_stats
        chunk_size, window = 64, 8
        num_chunks, max_windows = sparse_grid_stats(
            positions, leaf_level, chunk_size, window, ring)
        tree = build_grid_tree(positions, masses, leaf_level, 8,
                               agg_num_chunks=num_chunks,
                               agg_chunk_size=chunk_size)
        acc_sorted = fmm_accel_sorted(
            tree, order=order, ring=ring, softening=soft,
            leaf_batch=leaf_batch, num_chunks=num_chunks,
            chunk_size=chunk_size, window=window, max_windows=max_windows)
    else:
        p2p_impl = _resolve_p2p_impl(p2p_impl, positions.device)
        tree = build_grid_tree(positions, masses, leaf_level, capacity)
        acc_sorted = fmm_accel_sorted(
            tree, order=order, ring=ring, softening=soft,
            leaf_batch=leaf_batch, p2p_impl=p2p_impl)
    acc = torch.empty_like(acc_sorted)
    acc[tree.order] = acc_sorted
    return (config.G * masses)[:, None] * acc
