"""Hierarchical grid tree for the Barnes-Hut tier, in PyTorch.

Port of ``nbody_tpu.ops.grid_tree``. The tree is a level-synchronous uniform
grid over Morton keys:

* **Build**: quantize → Morton keys → stable argsort → per-level dense cell
  aggregates (mass, centre of mass, packed [com|mass], COM-centred second
  moments), from capacity-padded windows over the sorted bodies.
* **Far field**: at every level each leaf's ancestor interacts with its
  V-list (children of the parent's near ring that are not its own near
  ring; ring radius k ⇒ θ_eff = 1/(k+1)), per body (``"point"``), through a
  leaf-centred local expansion (``"local"``, ``"local_leaf"``), or through
  the hierarchical downward sweep of ``ops/hier_far.py`` (``"hier"``).
* **Near field**: leaf P2P over the (2k+1)^D neighbour cells with the
  always-on d² < 1e-10 pair guard, once per segment after the far field's
  leaf batches. For fp32 bodies on the card it is one launch of the
  hand-written kernel K6 (``ops/cuda_p2p.near_field_cuda``,
  ``csrc/p2p_leaf.cu``), which reads the tree's cells itself. Its plain
  version (CPU tensors, trees of another dtype under ``p2p_impl="auto"``,
  or ``p2p_impl="plain"``) forms the windows of :func:`near_field_inputs` per
  leaf batch: with k ≥ 2 the sources are gathered once per parent window
  and each of the 2^D child parities masks its own ring.

What differs from the JAX package, and why:

* Keys and leaf ids are int64 holding the uint32 values (torch's uint32
  supports few operators), as in ``ops/keys.py``.
* ``jax.lax.map`` over leaf batches and hier parent chunks is a Python loop
  over the same batches and chunks, so both packages take the same branches.
* ``compute_capacity_cached`` is dropped: its id()/weakref memo is exact only
  for immutable arrays, and torch tensors are mutable. Every call without an
  explicit ``capacity`` measures it (one device sync).
* ``_bh_grid_fused`` (jit fusion against relay latency) is the body of
  :func:`barnes_hut_grid`.
* The sparse build's scatter-adds (``.at[cell].add``) are ``index_add_``:
  a cell's chunks are summed locally, never as a cumsum difference. On CUDA
  its float order is not fixed from run to run.
* The sharded evaluation (``shard_axis``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from .brute_force import _DIST2_GUARD
from .keys import morton_key_from_coords, quantize

def _compact2(x):
    """Inverse of keys._spread2: even bits of a uint32 held in int64."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def _compact3(x):
    """Inverse of keys._spread3: every third bit of a uint32 held in int64."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    return (x | (x >> 16)) & 0x000003FF


def cell_coords(cell_ids: torch.Tensor, dim: int) -> torch.Tensor:
    """Morton cell id [M] → integer grid coords [M, dim] (int64)."""
    ids = cell_ids.to(torch.int64) & 0xFFFFFFFF
    if dim == 2:
        return torch.stack([_compact2(ids >> 1), _compact2(ids)], dim=-1)
    return torch.stack([_compact3(ids >> 2), _compact3(ids >> 1),
                        _compact3(ids)], dim=-1)


@dataclasses.dataclass(frozen=True)
class GridTree:
    """Flattened hierarchical grid; ``dim``, ``leaf_level`` and
    ``capacity`` are plain ints, every other field a tensor (or a tuple of
    per-level tensors, index 0 = root)."""

    dim: int
    leaf_level: int
    capacity: int

    lo: torch.Tensor  # [D] domain lower corner
    cell_sizes: torch.Tensor  # [L+1, D] cell size per level

    order: torch.Tensor  # [N] original index of each sorted slot
    leaf_ids: torch.Tensor  # [N] leaf cell id per sorted body
    pos_sorted: torch.Tensor  # [N, D]
    mass_sorted: torch.Tensor  # [N]

    level_mass: Tuple[torch.Tensor, ...]  # [(2^(D*l),)]
    level_com: Tuple[torch.Tensor, ...]  # [(2^(D*l), D)]

    # Each leaf is one contiguous run of the Morton-sorted bodies.
    cell_start: torch.Tensor  # [num_leaf_cells]
    cell_count: torch.Tensor  # [num_leaf_cells]

    # Row r holds the (pos|0, mass) 4-vectors of sorted bodies [8r, 8r+8).
    body_pack: torch.Tensor  # [ceil(N/8), 32]

    # Slot of sorted body i in its leaf's target window (_window_rows).
    window_slot: torch.Tensor  # [N]

    level_pack: Tuple[torch.Tensor, ...]  # [(2^(D*l), 4)] com|0, mass
    level_quad: Tuple[torch.Tensor, ...] = ()  # [(2^(D*l), nq)] with quad

    @property
    def n(self) -> int:
        return self.pos_sorted.shape[0]

    @property
    def num_leaf_cells(self) -> int:
        return 1 << (self.dim * self.leaf_level)


_STATIC_FIELDS = ("dim", "leaf_level", "capacity")


def grid_tree_from_numpy(fields, device) -> GridTree:
    """A :class:`GridTree` from a mapping of field name → numpy array (or a
    tuple of arrays for the per-level fields, an int for the static ones),
    e.g. the fields of a JAX ``GridTree`` passed through ``np.asarray``.
    Integer arrays become int64, floats keep their dtype."""
    def conv(a):
        a = np.array(a)  # a writable copy: JAX's arrays are read-only
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device)

    kw = {}
    for f in dataclasses.fields(GridTree):
        v = fields[f.name]
        if f.name in _STATIC_FIELDS:
            kw[f.name] = int(v)
        elif isinstance(v, (tuple, list)):
            kw[f.name] = tuple(conv(x) for x in v)
        else:
            kw[f.name] = conv(v)
    return GridTree(**kw)


def auto_leaf_level(n: int, dim: int, target_occupancy: Optional[int] = None,
                    max_level: Optional[int] = None, k: int = 1) -> int:
    """Leaf depth so cells average ~target_occupancy bodies, as the JAX
    package chooses it (occupancy 64 in 2D / 32 in 3D, scaled by
    (3/(2k+1))^D for wider rings; floor, so leaves land in
    [target, target·2^D))."""
    if target_occupancy is None:
        target_occupancy = 64 if dim == 2 else 32
        if k > 1:
            target_occupancy = max(
                8, int(target_occupancy * (3.0 / (2 * k + 1)) ** dim))
    level = max(1, math.floor(math.log2(max(n, 2) / target_occupancy) / dim))
    cap = {2: 13, 3: 8}[dim]  # ≤ 2^26 / 2^24 dense leaf cells
    if max_level is not None:
        cap = min(cap, max_level)
    return min(level, cap)


def compute_capacity(positions: torch.Tensor, leaf_level: int) -> int:
    """Max leaf occupancy rounded up to a multiple of 8 (at least 8); one
    device sync."""
    dim = positions.shape[1]
    ids = morton_key_from_coords(quantize(positions, leaf_level), leaf_level)
    counts = torch.bincount(ids, minlength=1 << (dim * leaf_level))
    cmax = int(counts.max())
    return max(8, -(-cmax // 8) * 8)


# Above this leaf capacity the uniform grid has degenerated (a Plummer-core
# density peak): near-field work scales with capacity².
CLUSTERED_CAPACITY_LIMIT = 4096


def dense_layout_degenerate(capacity: int, n: int, leaf_level: int,
                            dim: int) -> bool:
    """True when the capacity-padded dense layout should not be used: the
    absolute capacity guard, or max/mean occupancy skew above 16× (uniform
    inputs stay ≲ 5×)."""
    mean_occ = n / float(1 << (dim * leaf_level))
    return capacity > CLUSTERED_CAPACITY_LIMIT or (
        capacity > 512 and capacity > 16 * mean_occ)


def check_grid_capacity(capacity: int, n: int, leaf_level: int, dim: int,
                        what: str, limit: Optional[int] = None) -> None:
    """Refuse, with guidance, to run a degenerate uniform grid."""
    limit = CLUSTERED_CAPACITY_LIMIT if limit is None else limit
    if capacity > limit:
        ncells = 1 << (dim * leaf_level)
        raise ValueError(
            f"{what}: the densest leaf cell holds {capacity} of {n} bodies "
            f"(leaf level {leaf_level}, {ncells} cells, mean occupancy "
            f"{n / ncells:.1f}) — this input is too clustered for the "
            f"uniform grid tree, whose near-field work scales with the max "
            f"leaf occupancy squared. Pass leaf_level/capacity explicitly to "
            f"override this guard.")


def _quad_pairs(dim: int):
    """Packed index pairs of the symmetric second-moment tensor."""
    return ([(0, 0), (1, 1), (0, 1)] if dim == 2
            else [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)])


def leaf_window_sums(body_pack, starts, ends, *, capacity, ncells, dim,
                     quad=False):
    """Per-cell mass, mass-weighted position and (with ``quad``) COM-centred
    second moments from superrow windows over the sorted packed bodies.
    Returns (m [C], mx [C, D], S [C, nq] | None)."""
    dev = body_pack.device
    TW = capacity // 8 + 1
    nsr = body_pack.shape[0]
    sr_raw = (starts // 8)[:, None] + torch.arange(TW, device=dev)
    rows = body_pack[sr_raw.clamp(0, nsr - 1)]  # [C, TW, 32]
    wbodies = rows.reshape(ncells, TW * 8, 4)
    gidx = (sr_raw[..., None] * 8
            + torch.arange(8, device=dev)).reshape(ncells, TW * 8)
    wvalid = (gidx >= starts[:, None]) & (gidx < ends[:, None])
    wmass = wbodies[..., 3] * wvalid
    m = wmass.sum(dim=1)
    mx = (wmass[..., None] * wbodies[..., :dim]).sum(dim=1)
    S = None
    if quad:
        com = mx / m.clamp(min=1e-30)[:, None]
        dxw = wbodies[..., :dim] - com[:, None, :]
        S = torch.stack([(wmass * dxw[..., a] * dxw[..., b]).sum(dim=1)
                         for a, b in _quad_pairs(dim)], dim=-1)
    return m, mx, S


def reduce_levels(m_l, mx_l, S_l, *, dim, L, dtype):
    """Bottom-up 2^D-child reduction of leaf (mass, m·x[, S]) into per-level
    (mass, COM, [com|mass] pack, quad) tables; second moments translate by
    the parallel-axis identity S_p = Σ_c [S_c + m_c·(com_c−com_p)⊗²]."""
    qpairs = _quad_pairs(dim)
    level_mass: List[torch.Tensor] = []
    level_com: List[torch.Tensor] = []
    level_pack: List[torch.Tensor] = []
    level_quad: List[torch.Tensor] = []
    nch = 1 << dim
    for l in range(L, -1, -1):
        com_l = mx_l / m_l.clamp(min=1e-30)[:, None]
        pack_l = torch.zeros((m_l.shape[0], 4), dtype=dtype,
                             device=m_l.device)
        pack_l[:, :dim] = com_l
        pack_l[:, 3] = m_l
        level_mass.append(m_l)
        level_com.append(com_l)
        level_pack.append(pack_l)
        if S_l is not None:
            level_quad.append(S_l)
        if l > 0:
            m_p = m_l.reshape(-1, nch).sum(dim=1)
            mx_p = mx_l.reshape(-1, nch, dim).sum(dim=1)
            if S_l is not None:
                com_p = mx_p / m_p.clamp(min=1e-30)[:, None]
                d = com_l.reshape(-1, nch, dim) - com_p[:, None, :]
                mc = m_l.reshape(-1, nch)
                S_l = (S_l.reshape(-1, nch, len(qpairs))
                       + mc[..., None] * torch.stack(
                           [d[..., a] * d[..., b] for a, b in qpairs],
                           dim=-1)).sum(dim=1)
            m_l, mx_l = m_p, mx_p
    level_mass.reverse()
    level_com.reverse()
    level_pack.reverse()
    level_quad.reverse()
    return level_mass, level_com, level_pack, level_quad


def chunk_table(starts, counts, *, chunk: int, num_chunks: int):
    """Cell-aligned chunks of at most ``chunk`` sorted bodies: each cell's
    contiguous run split into ⌈count/chunk⌉ chunks that never straddle a
    cell boundary. ``num_chunks`` rows (the exact total from
    ``sparse_grid.sparse_grid_stats``); rows past the true total have
    length 0.

    Returns (cell [NT], cstart [NT], clen [NT], coffs [ncells + 1]), int64,
    ``coffs`` the exclusive prefix sum of the per-cell chunk counts.
    """
    ncells = counts.shape[0]
    nchunk = -(-counts // chunk)
    coffs = torch.cat([counts.new_zeros(1), torch.cumsum(nchunk, 0)])
    r = torch.arange(num_chunks, dtype=coffs.dtype, device=coffs.device)
    cell = (torch.searchsorted(coffs, r, right=True) - 1).clamp(0, ncells - 1)
    within = r - coffs[cell]
    cstart = starts[cell] + within * chunk
    clen = (counts[cell] - within * chunk).clamp(0, chunk)
    clen = torch.where(r < coffs[-1], clen, torch.zeros_like(clen))
    return cell, cstart, clen, coffs


def _leaf_chunk_sums(body_rows, starts, counts, *, num_chunks, chunk, ncells,
                     dim, quad):
    """Leaf (m [C], mx [C, D], S [C, nq] | None) from masked per-chunk
    partial sums of ``body_rows`` [N8, 4] added into the cells: O(N) memory
    however clustered the bodies are. The same sums as
    :func:`leaf_window_sums`, second moments about the leaf COM, partitioned
    by chunk."""
    cell, cstart, clen, _ = chunk_table(starts, counts, chunk=chunk,
                                        num_chunks=num_chunks)
    ar = torch.arange(chunk, device=body_rows.device)
    rows = body_rows[(cstart[:, None] + ar).clamp(0, body_rows.shape[0] - 1)]
    w = rows[..., 3] * (ar < clen[:, None])
    dt = body_rows.dtype
    m = torch.zeros(ncells, dtype=dt, device=body_rows.device)\
        .index_add_(0, cell, w.sum(1))
    mx = torch.zeros((ncells, dim), dtype=dt, device=body_rows.device)\
        .index_add_(0, cell, (w[..., None] * rows[..., :dim]).sum(1))
    S = None
    if quad:
        com = mx / m.clamp(min=1e-30)[:, None]
        d = rows[..., :dim] - com[cell][:, None, :]
        qp = _quad_pairs(dim)
        S = torch.zeros((ncells, len(qp)), dtype=dt, device=body_rows.device)\
            .index_add_(0, cell, torch.stack(
                [(w * d[..., a] * d[..., b]).sum(1) for a, b in qp], dim=-1))
    return m, mx, S


def build_grid_tree(positions: torch.Tensor, masses: torch.Tensor,
                    leaf_level: int, capacity: int, quad: bool = False,
                    agg_num_chunks: Optional[int] = None,
                    agg_chunk_size: int = 64) -> GridTree:
    """Level-synchronous build (the reference's octree.cpp:165-204 insert).

    ``quad=True`` also builds the per-level second moments.
    ``agg_num_chunks`` takes the leaf aggregates from cell-aligned chunks of
    ``agg_chunk_size`` bodies (:func:`_leaf_chunk_sums`), the sparse path's
    build, whose max leaf occupancy is unbounded; ``capacity`` is then only
    the metadata of :func:`_window_rows`, which the sparse evaluation never
    calls.
    """
    n, dim = positions.shape
    L = leaf_level
    dt, dev = positions.dtype, positions.device

    # Domain bounds with the reference's 1% padding (octree.cpp:170-188),
    # in the JAX operation order so fp32 keys are bit-identical.
    mins = positions.min(dim=0).values
    maxs = positions.max(dim=0).values
    center = 0.5 * (mins + maxs)
    half = (0.5 * (maxs - mins) * torch.tensor(1.01, dtype=dt)
            + torch.tensor(1e-30, dtype=dt))
    lo, hi = center - half, center + half

    keys = morton_key_from_coords(quantize(positions, L, lo=lo, hi=hi), L)
    order = torch.argsort(keys, stable=True)  # jnp.argsort is stable
    leaf_ids = keys[order]
    pos_s = positions[order]
    mass_s = masses[order]

    cell_sizes = torch.stack([(hi - lo) / (1 << l) for l in range(L + 1)])

    num_leaf_cells = 1 << (dim * L)
    all_cells = torch.arange(num_leaf_cells, dtype=leaf_ids.dtype,
                             device=dev)
    starts = torch.searchsorted(leaf_ids, all_cells)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    counts = ends - starts

    np8 = -(-n // 8) * 8
    bt = torch.zeros((np8, 4), dtype=dt, device=dev)
    bt[:n, :dim] = pos_s
    bt[:n, 3] = mass_s
    body_pack = bt.reshape(np8 // 8, 32)

    if agg_num_chunks is not None:
        m_leaf, mx_leaf, S_leaf = _leaf_chunk_sums(
            bt, starts, counts, num_chunks=agg_num_chunks,
            chunk=agg_chunk_size, ncells=num_leaf_cells, dim=dim, quad=quad)
    else:
        m_leaf, mx_leaf, S_leaf = leaf_window_sums(
            body_pack, starts, ends, capacity=capacity,
            ncells=num_leaf_cells, dim=dim, quad=quad)
    level_mass, level_com, level_pack, level_quad = reduce_levels(
        m_leaf, mx_leaf, S_leaf, dim=dim, L=L, dtype=dt)

    body_start = starts[leaf_ids]
    window_slot = torch.arange(n, device=dev) - (body_start // 8) * 8

    return GridTree(
        dim=dim, leaf_level=L, capacity=capacity,
        lo=lo, cell_sizes=cell_sizes,
        order=order, leaf_ids=leaf_ids, pos_sorted=pos_s, mass_sorted=mass_s,
        level_mass=tuple(level_mass), level_com=tuple(level_com),
        cell_start=starts, cell_count=counts,
        body_pack=body_pack, level_pack=tuple(level_pack),
        window_slot=window_slot, level_quad=tuple(level_quad))


def _ring_offsets(dim: int, k: int) -> Tuple[np.ndarray, int]:
    """Candidate child-cell offsets relative to 2·parent coords (every child
    of every near-parent), [(2k+1)^D·2^D, D], and the near radius k."""
    parent_offs = np.array(
        list(itertools.product(range(-k, k + 1), repeat=dim)), np.int64)
    child_offs = np.array(list(itertools.product((0, 1), repeat=dim)),
                          np.int64)
    cands = parent_offs[:, None, :] * 2 + child_offs[None, :, :]
    return cands.reshape(-1, dim), k


def _neighbor_offsets(dim: int, k: int) -> np.ndarray:
    return np.array(list(itertools.product(range(-k, k + 1), repeat=dim)),
                    np.int64)


@functools.lru_cache(maxsize=None)
def _parent_window(dim: int, k: int):
    """Static tables of the parent-shared near field: (offsets
    [(2k+2)^D, D] relative to 2·parent coords, masks [2^D, (2k+2)^D] — cell
    usable by child parity)."""
    offs = np.array(list(itertools.product(range(-k, k + 2), repeat=dim)),
                    np.int64)
    masks = np.zeros((1 << dim, len(offs)), np.float32)
    for pm in range(1 << dim):
        par = np.array([(pm >> (dim - 1 - d)) & 1 for d in range(dim)],
                       np.int64)
        masks[pm] = (np.abs(offs - par).max(axis=1) <= k).astype(np.float32)
    return offs, masks


@functools.lru_cache(maxsize=None)
def _leaf_shell_subset(dim: int, k: int, c_gate: int):
    """Per-parity candidate subsets whose shell (k < cheb ≤ c_gate) stays
    per-body in the ``"local_leaf"`` split: (idx [2^D, m], valid [2^D, m]).
    Parity bit d is coordinate d's LSB."""
    cands, _ = _ring_offsets(dim, k)
    sels = []
    for pbits in range(1 << dim):
        par = np.array([(pbits >> d) & 1 for d in range(dim)], np.int64)
        cheb = np.abs(cands - par).max(axis=1)
        sels.append(np.where((cheb > k) & (cheb <= c_gate))[0])
    m = max(len(s) for s in sels)
    idx = np.zeros((1 << dim, m), np.int64)
    valid = np.zeros((1 << dim, m), bool)
    for p, s in enumerate(sels):
        idx[p, :len(s)] = s
        valid[p, :len(s)] = True
    return idx, valid


P2P_IMPLS = ("auto", "plain", "cuda")


def _resolve_p2p_impl(p2p_impl: str, device: torch.device) -> str:
    """Check ``p2p_impl`` against the tree's device and return it.
    ``"cuda"`` for CPU tensors raises. ``"auto"`` stays ``"auto"``;
    :func:`_near_field_accel` resolves it by the tree's dtype."""
    if p2p_impl not in P2P_IMPLS:
        raise ValueError(f"p2p_impl must be one of {P2P_IMPLS}, "
                         f"got {p2p_impl!r}")
    if p2p_impl == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(f"p2p_impl='cuda' runs the K6 kernel and needs CUDA "
                         f"tensors; the tree is on {device}")
    return p2p_impl


def _near_field_accel(tree, k, softening, p2p_impl, leaf0, nleaves,
                      leaf_batch):
    """Near field [N, D] of the bodies of leaves [leaf0, leaf0 + nleaves)
    in sorted-body order, zero elsewhere.

    ``"cuda"``: K6's wrapper, which on CUDA tensors makes one launch in
    fp32 and casts back to the tree's dtype, whatever that dtype is (the
    JAX package's explicit ``"pallas"`` is its fp32 kernel too).
    ``"auto"``: K6's wrapper for an fp32 tree (the kernel on the card, the
    plain version on the CPU); any other tree takes the plain near field in
    its own dtype, as the JAX package's ``"auto"`` (its jnp path) does, so
    an f64 run keeps f64 near pairs. ``"plain"``: the windowed plain
    version on any device.
    """
    from . import cuda_p2p
    kernel = p2p_impl == "cuda" or (
        p2p_impl == "auto" and tree.pos_sorted.dtype == torch.float32)
    fn = cuda_p2p.near_field_cuda if kernel else cuda_p2p.near_field_plain
    return fn(tree, k, softening, leaf0, nleaves, leaf_batch)


def near_field_inputs(tree: GridTree, k: int, leaf_ids_b, tb):
    """The leaf near field of one batch of leaves as near-field calls.

    leaf_ids_b: [B] dense leaf ids; tb: [B, TWR, 4] their target windows
    (:func:`_window_rows`). Returns (calls, shared): a list of
    (targets [B', TWR, D], src4 [B', S, 4]) with invalid sources at mass 0.
    With k ≥ 2 and B a multiple of 2^D (``shared``), the sources are
    gathered once per parent over its (2k+2)^D window and there is one call
    per child parity (B' = B / 2^D), its ring's cells kept by a static mask;
    their outputs stack on axis 1 back to leaf order. Otherwise one call
    over each leaf's (2k+1)^D neighbour cells (B' = B).
    """
    dim, L = tree.dim, tree.leaf_level
    dt, dev = tree.pos_sorted.dtype, tree.pos_sorted.device
    B, twr = tb.shape[0], tb.shape[1]
    nch = 1 << dim
    if k >= 2 and B % nch == 0:
        Bp = B // nch
        offs_np, masks_np = _parent_window(dim, k)
        parent_ids = leaf_ids_b.reshape(Bp, nch)[:, 0] >> dim
        w_xy = cell_coords(parent_ids, dim)[:, None, :] * 2 \
            + torch.as_tensor(offs_np, device=dev)[None, :, :]
        w_ids = _clipped_ids(w_xy, L, dim, (Bp, -1))
        sb, _, svalid = _window_rows(tree, w_ids)  # [Bp, W, SWR, 4]
        smass = sb[..., 3] * (svalid & _in_bounds(w_xy, L)[:, :, None])
        masks = torch.as_tensor(masks_np, dtype=dt, device=dev)
        tb_p = tb.reshape(Bp, nch, twr, 4)
        calls = [(tb_p[:, pm, :, :dim],
                  torch.cat([sb[..., :3], (smass * masks[pm][None, :, None])
                             [..., None]], dim=-1).reshape(Bp, -1, 4))
                 for pm in range(nch)]
        return calls, True
    nb_xy = cell_coords(leaf_ids_b, dim)[:, None, :] \
        + torch.as_tensor(_neighbor_offsets(dim, k), device=dev)[None, :, :]
    nb_ids = _clipped_ids(nb_xy, L, dim, (B, -1))
    sb, _, svalid = _window_rows(tree, nb_ids)  # [B, nnear, SWR, 4]
    smass = sb[..., 3] * (svalid & _in_bounds(nb_xy, L)[:, :, None])
    src4 = torch.cat([sb[..., :3], smass[..., None]], dim=-1)
    return [(tb[..., :dim], src4.reshape(B, -1, 4))], False


def _window_rows_raw(body_pack, cell_start, cell_count, capacity, cell_ids):
    """Gather each cell's contiguous body run as packed superrows.

    cell_ids: [...] dense leaf ids. Returns (bodies [..., TW*8, 4] packed
    (pos|0, mass), gidx [..., TW*8] sorted-body index, valid mask).
    """
    dev = body_pack.device
    TW = capacity // 8 + 1
    start = cell_start[cell_ids]
    count = cell_count[cell_ids]
    nsr = body_pack.shape[0]
    sr_raw = start.div(8, rounding_mode="floor")[..., None] \
        + torch.arange(TW, device=dev)
    rows = body_pack[sr_raw.clamp(0, nsr - 1)]  # [..., TW, 32]
    bodies = rows.reshape(rows.shape[:-2] + (TW * 8, 4))
    gidx = (sr_raw[..., None] * 8 + torch.arange(8, device=dev)).reshape(
        sr_raw.shape[:-1] + (TW * 8,))
    # Rows past the end clip to the last superrow; their gidx ≥ n keeps them
    # masked.
    valid = (gidx >= start[..., None]) & (gidx < (start + count)[..., None])
    return bodies, gidx, valid


def _window_rows(tree: GridTree, cell_ids):
    return _window_rows_raw(tree.body_pack, tree.cell_start,
                            tree.cell_count, tree.capacity, cell_ids)


def _point_mass_accel(targets, src_pos, src_mass, softening):
    """Σ_s m_s (x_s − x_t)/(r²+ε²)^{3/2} with the always-on coincident-pair
    guard (raw d² < 1e-10). targets [B, C, D]; src_pos [B, S, D]; src_mass
    [B, S] → [B, C, D]. The plain version of K6's path."""
    dim = targets.shape[-1]
    diffs = []
    d2 = None
    for d in range(dim):
        diff = src_pos[:, None, :, d] - targets[:, :, None, d]  # [B, C, S]
        diffs.append(diff)
        d2 = diff * diff if d2 is None else d2 + diff * diff
    soft = torch.tensor(softening, dtype=d2.dtype)
    inv_r = torch.rsqrt(d2 + soft * soft)
    w = src_mass[:, None, :] * (inv_r * inv_r * inv_r)
    w = torch.where(d2 < _DIST2_GUARD, torch.zeros_like(w), w)
    return torch.stack([(w * diffs[d]).sum(dim=-1) for d in range(dim)],
                       dim=-1)


def _quad_cell_accel(targets, com, mass, S):
    """Monopole + quadrupole cell → body acceleration, in normalized form
    (n = R/r, Ŝ = S/r²):

        a = [ (M + (15/2)·nᵀŜn − (3/2)·tr Ŝ)·n − 3·Ŝn ] · u²

    Guard on r² (coincident / empty cells). Masked cells must arrive with
    mass 0 and S 0. targets [B, C, D]; com [B, K, D]; mass [B, K];
    S [B, K, nq] → [B, C, D].
    """
    dim = targets.shape[-1]
    qpairs = _quad_pairs(dim)
    R = [com[:, None, :, d] - targets[:, :, None, d] for d in range(dim)]
    r2 = R[0] * R[0]
    for Rd in R[1:]:
        r2 = r2 + Rd * Rd
    u = torch.rsqrt(r2)
    u = torch.where(r2 < _DIST2_GUARD, torch.zeros_like(u), u)
    u2 = u * u
    n = [Rd * u for Rd in R]
    comp = {p: S[..., i][:, None, :] for i, p in enumerate(qpairs)}

    def s_hat(a, b):
        raw = comp[(a, b)] if (a, b) in comp else comp[(b, a)]
        return raw * u2

    Sn = [sum(s_hat(d, e) * n[e] for e in range(dim)) for d in range(dim)]
    nSn = sum(n[d] * Sn[d] for d in range(dim))
    trS = sum(s_hat(d, d) for d in range(dim))
    radial = (mass[:, None, :] + 7.5 * nSn - 1.5 * trS) * u2
    return torch.stack([(radial * n[d] - (3.0 * u2) * Sn[d]).sum(dim=-1)
                        for d in range(dim)], dim=-1)


def _clipped_ids(xy, level: int, dim: int, shape):
    """Morton ids of grid coords clipped into [0, 2^level), reshaped."""
    ids = morton_key_from_coords(
        xy.clamp(0, (1 << level) - 1).reshape(-1, dim), level)
    return ids.reshape(shape)


def _in_bounds(xy, level: int):
    return ((xy >= 0) & (xy < (1 << level))).all(dim=-1)


def far_field_rings(tree: GridTree, leaf_ids_b: torch.Tensor,
                    tpos: torch.Tensor, *, k: int, multipole: str,
                    levels=None, far_impl: str = "point",
                    local_ratio: Optional[float] = None) -> torch.Tensor:
    """Telescoping V-list far field for a batch of leaf target groups.

    At every level 2..L the group's ancestor interacts with its V-list
    (children of the parent's near ring beyond Chebyshev k) by monopole or
    monopole + quadrupole, per body. ``far_impl="local"`` accumulates
    eligible levels into an order-2 expansion at the leaf centre;
    ``"local_leaf"`` also splits the leaf ring by shell (inner shells per
    body, the rest through an order-3 expansion). Returns the increment for
    ``tpos`` [B, T, D].
    """
    dim, L = tree.dim, tree.leaf_level
    dt, dev = tree.pos_sorted.dtype, tree.pos_sorted.device
    B = leaf_ids_b.shape[0]
    cand_offs = torch.as_tensor(_ring_offsets(dim, k)[0], device=dev)
    acc = torch.zeros(tpos.shape, dtype=dt, device=dev)
    use_local = far_impl in ("local", "local_leaf")
    order3 = far_impl == "local_leaf"
    any_local = False
    if use_local:
        from .local_expansion import (LOCAL_RATIO_DEFAULT, eval_local,
                                      local_coeffs, num_coeffs, num_coeffs3,
                                      ring_level_is_local)
        if local_ratio is None:
            local_ratio = LOCAL_RATIO_DEFAULT
        leaf_xy = cell_coords(leaf_ids_b, dim)
        center = tree.lo + (leaf_xy.to(dt) + 0.5) * tree.cell_sizes[L]
        _, nj, nh = num_coeffs(dim)
        a0 = torch.zeros((B, dim), dtype=dt, device=dev)
        Jp = torch.zeros((B, nj), dtype=dt, device=dev)
        Hp = torch.zeros((B, nh), dtype=dt, device=dev)
        Kp = (torch.zeros((B, num_coeffs3(dim)), dtype=dt, device=dev)
              if order3 else None)
    for l in (range(2, L + 1) if levels is None else levels):
        anc = leaf_ids_b.to(torch.int64) >> (dim * (L - l))
        anc_xy = cell_coords(anc, dim)  # [B, D]
        parent_xy = anc_xy >> 1
        cand_xy = parent_xy[:, None, :] * 2 + cand_offs[None, :, :]
        cheb = (cand_xy - anc_xy[:, None, :]).abs().amax(dim=-1)
        is_far = (cheb > k) & _in_bounds(cand_xy, l)  # V-list membership
        cand_ids = _clipped_ids(cand_xy, l, dim, (B, -1))
        cpack = tree.level_pack[l][cand_ids]  # [B, ncand, 4]
        cmass = cpack[..., 3] * is_far
        ccom = cpack[..., :dim]
        local_l = use_local and ring_level_is_local(
            dim, k, L, l, local_ratio, include_leaf=order3)
        if local_l and l == L:
            # Leaf-level shell split: shells beyond c_gate go local, the
            # inner far shells stay per body.
            c_gate = math.ceil(dim ** 0.5 / (2.0 * local_ratio)) - 1
            mask_loc = is_far & (cheb > c_gate)
            cS = (tree.level_quad[l][cand_ids] * mask_loc[..., None]
                  if multipole == "quad" else None)
            da0, dJ, dH, dK = local_coeffs(center, ccom,
                                           cpack[..., 3] * mask_loc, cS,
                                           order3=True)
            a0, Jp, Hp, Kp = a0 + da0, Jp + dJ, Hp + dH, Kp + dK
            any_local = True
            idx_tab, valid_tab = _leaf_shell_subset(dim, k, c_gate)
            if idx_tab.shape[1] > 0:
                par_bits = anc_xy & 1
                pidx = sum(par_bits[:, d] << d for d in range(dim))  # [B]
                idx_b = torch.as_tensor(idx_tab, device=dev)[pidx]  # [B, m]
                sub_mask = (torch.gather(is_far, 1, idx_b)
                            & torch.as_tensor(valid_tab, device=dev)[pidx])
                sub_pack = torch.gather(
                    cpack, 1, idx_b[..., None].expand(-1, -1, 4))
                sub_mass = sub_pack[..., 3] * sub_mask
                sub_com = sub_pack[..., :dim]
                if multipole == "quad":
                    cq = tree.level_quad[l][cand_ids]
                    sub_quad = torch.gather(
                        cq, 1, idx_b[..., None].expand(-1, -1, cq.shape[-1])
                    ) * sub_mask[..., None]
                    acc = acc + _quad_cell_accel(tpos, sub_com, sub_mass,
                                                 sub_quad)
                else:
                    acc = acc + _point_mass_accel(tpos, sub_com, sub_mass,
                                                  0.0)
        elif local_l:
            cS = (tree.level_quad[l][cand_ids] * is_far[..., None]
                  if multipole == "quad" else None)
            out_l = local_coeffs(center, ccom, cmass, cS, order3=order3)
            a0, Jp, Hp = a0 + out_l[0], Jp + out_l[1], Hp + out_l[2]
            if order3:
                Kp = Kp + out_l[3]
            any_local = True
        elif multipole == "quad":
            cquad = tree.level_quad[l][cand_ids] * is_far[..., None]
            acc = acc + _quad_cell_accel(tpos, ccom, cmass, cquad)
        else:
            acc = acc + _point_mass_accel(tpos, ccom, cmass, 0.0)
    if use_local and any_local:
        acc = acc + eval_local(tpos - center[:, None, :], a0, Jp, Hp, Kp)
    return acc


#: Bytes of the near-field source tensor one leaf batch may hold (the JAX
#: package's clamp, grid_tree.py:902-908).
_NEAR_BATCH_BYTES = 1e9
#: Estimated hier pack-mode output above which the sweep switches to
#: traversal-side gathers (grid_tree.py:930-932).
_HIER_PACK_BYTES = 1 << 30


def near_batch_plan(tree: GridTree, k: int, leaf_batch: int = 512,
                    num_segments: int = 1) -> Tuple[int, int]:
    """(leaf_batch, number of batches) after the JAX package's clamps: the
    batch is at most the segment's leaves and keeps the
    [B, (2k+1)^D·TWR, 4] near tensor near 1 GB."""
    my_leaves = tree.num_leaf_cells // num_segments
    twr = (tree.capacity // 8 + 1) * 8
    mem_cap = max(1, 1 << int(math.floor(math.log2(
        max(1.0, _NEAR_BATCH_BYTES / ((2 * k + 1) ** tree.dim * twr * 16))))))
    lb = min(leaf_batch, mem_cap, my_leaves)
    return lb, my_leaves // lb


def grid_tree_accel_sorted(tree: GridTree, k: int = 1,
                           softening: float = 0.0,
                           leaf_batch: int = 512,
                           p2p_impl: str = "auto",
                           multipole: str = "mono",
                           num_segments: int = 1,
                           segment_index: int = 0,
                           far_impl: str = "point",
                           hier_coeffs=None,
                           _debug_skip: str = "") -> torch.Tensor:
    """Barnes-Hut accelerations [N, D] of the sorted bodies, not G-scaled.

    Far field per ``far_impl`` (``"hier"``: the sweep of ``ops/hier_far.py``
    once, then per leaf batch one order-3 evaluation plus the per-body
    inner shells, from pack tensors or, above ~1 GiB or with
    ``hier_coeffs``, gathered per batch), over the leaves in batches of
    ``leaf_batch`` (clamped as in the JAX package). Near field: leaf P2P
    over the (2k+1)^D neighbourhood, one call for the segment's leaves
    (:func:`_near_field_accel`), added to each body's far field after the
    batches. ``num_segments`` > 1 evaluates only segment
    ``segment_index``'s leaves. ``_debug_skip`` containing ``"far"`` /
    ``"near"`` skips that part (phase timing).
    """
    dim, L, C = tree.dim, tree.leaf_level, tree.capacity
    dt, dev = tree.pos_sorted.dtype, tree.pos_sorted.device
    p2p_impl = _resolve_p2p_impl(p2p_impl, dev)
    my_leaves = tree.num_leaf_cells // num_segments
    chunk0 = int(segment_index) * my_leaves if num_segments > 1 else 0
    leaf_batch, nb = near_batch_plan(tree, k, leaf_batch, num_segments)
    nch = 1 << dim
    twr = (C // 8 + 1) * 8

    far_on = "far" not in _debug_skip
    hier_on = far_impl == "hier" and far_on
    hier_xs = ()
    hier_gather = False
    hier_tables = None
    if hier_on:
        from .hier_far import hier_far_coeffs, leaf_defer_tables
        offs_np_h, valid_np_h = leaf_defer_tables(dim, k)
        md_h = offs_np_h.shape[1]
        nq_h = len(_quad_pairs(dim)) if multipole == "quad" else 0
        est_pack_bytes = tree.num_leaf_cells * md_h * (dim + 1 + nq_h) * 4
        hier_gather = (hier_coeffs is not None
                       or est_pack_bytes > _HIER_PACK_BYTES)
        if hier_coeffs is not None:
            h_coeffs, h_dp, h_dq = hier_coeffs, None, None
        else:
            h_coeffs, h_dp, h_dq = hier_far_coeffs(
                tree, k, multipole=multipole,
                defer="gather" if hier_gather else "pack")
        if hier_gather and md_h:
            hier_tables = (torch.as_tensor(offs_np_h, device=dev),
                           torch.as_tensor(valid_np_h, dtype=dt, device=dev))

        def _chunk(x):
            part = x[chunk0:chunk0 + my_leaves]
            return part.reshape((nb, leaf_batch) + part.shape[1:])

        hier_xs = tuple(_chunk(x) for x in h_coeffs)
        if not hier_gather:
            hier_xs = hier_xs + (_chunk(h_dp),)
            if h_dq is not None:
                hier_xs = hier_xs + (_chunk(h_dq),)

    def far_batch(leaf_ids_b, extra):
        B = leaf_ids_b.shape[0]
        tb, _, _ = _window_rows(tree, leaf_ids_b)  # [B, TWR, 4]
        tpos = tb[..., :dim]
        acc = torch.zeros(tpos.shape, dtype=dt, device=dev)

        if hier_on:
            from .local_expansion import eval_local
            a0_b, J_b, H_b, K_b = extra[:4]
            leaf_xy_h = cell_coords(leaf_ids_b, dim)
            center = tree.lo + (leaf_xy_h.to(dt) + 0.5) * tree.cell_sizes[L]
            acc = acc + eval_local(tpos - center[:, None, :],
                                   a0_b, J_b, H_b, K_b)
            if hier_gather and hier_tables is not None:
                # Inner far shells, gathered per batch from the leaf-level
                # summaries (static per-parity offsets in leaf units).
                offs_t, valid_t = hier_tables
                pm_b = leaf_ids_b & (nch - 1)
                dxy = leaf_xy_h[:, None, :] + offs_t[pm_b]  # [B, md, D]
                d_ok = _in_bounds(dxy, L)
                d_ids = _clipped_ids(dxy, L, dim, (B, -1))
                dpack = tree.level_pack[L][d_ids]  # [B, md, 4]
                dmass = dpack[..., 3] * valid_t[pm_b] * d_ok
                if multipole == "quad":
                    dq = tree.level_quad[L][d_ids] \
                        * (valid_t[pm_b] * d_ok)[..., None]
                    acc = acc + _quad_cell_accel(
                        tpos, dpack[..., :dim], dmass, dq)
                else:
                    acc = acc + _point_mass_accel(
                        tpos, dpack[..., :dim], dmass, 0.0)
            elif not hier_gather and extra[4].shape[1]:
                dp_b = extra[4].reshape(B, -1, dim + 1)
                if multipole == "quad":
                    dq_b = extra[5].reshape(B, dp_b.shape[1], -1)
                    acc = acc + _quad_cell_accel(
                        tpos, dp_b[..., :dim], dp_b[..., dim], dq_b)
                else:
                    acc = acc + _point_mass_accel(
                        tpos, dp_b[..., :dim], dp_b[..., dim], 0.0)
        else:
            acc = acc + far_field_rings(tree, leaf_ids_b, tpos, k=k,
                                        multipole=multipole,
                                        far_impl=far_impl)
        return acc

    if far_on:
        ids = torch.arange(chunk0, chunk0 + my_leaves,
                           device=dev).reshape(nb, leaf_batch)
        accs = torch.empty((nb, leaf_batch, twr, dim), dtype=dt, device=dev)
        for b in range(nb):
            accs[b] = far_batch(ids[b], [x[b] for x in hier_xs])
        # Window layout → sorted order is a gather: each body occupies
        # exactly one window slot.
        acc_flat = accs.reshape(-1, dim)
        src = (tree.leaf_ids - chunk0) * twr + tree.window_slot
        in_chunk = ((tree.leaf_ids >= chunk0)
                    & (tree.leaf_ids < chunk0 + my_leaves))
        acc = acc_flat[torch.where(in_chunk, src, 0)] * in_chunk[:, None]
    else:
        acc = torch.zeros((tree.n, dim), dtype=dt, device=dev)
    if "near" not in _debug_skip:
        acc = acc + _near_field_accel(tree, k, softening, p2p_impl, chunk0,
                                      my_leaves, leaf_batch)
    return acc


def theta_to_ring(theta: float) -> int:
    """Opening angle → ring radius: θ_eff = 1/(k+1) ≤ θ."""
    return max(1, math.ceil(1.0 / max(theta, 1e-3)) - 1)


def resolve_bh_params(n: int, dim: int, theta: float,
                      far_impl: Optional[str] = None,
                      leaf_level: Optional[int] = None,
                      leaf_batch: int = 512,
                      multipole: str = "quad") -> dict:
    """Every static Barnes-Hut decision for (n, dim, θ), as the JAX package
    resolves them: far field "hier" for k ≥ 2 else "local"; 3D k ≥ 3 from
    2e6 bodies takes 256-leaf batches, and from 4e6 four segments."""
    k = theta_to_ring(theta)
    if far_impl is None:
        far_impl = "hier" if k >= 2 else "local"
    num_segments = 1
    if dim == 3 and k >= 3 and n >= 2_000_000:
        leaf_batch = min(leaf_batch, 256)
        if n >= 4_000_000:
            num_segments = 4
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim, k=k)
    return {"theta": theta, "k": k, "far_impl": far_impl,
            "multipole": multipole, "leaf_level": leaf_level,
            "leaf_batch": leaf_batch, "num_segments": num_segments}


def barnes_hut_grid(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    theta: Optional[float] = None,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    leaf_batch: int = 512,
    p2p_impl: str = "auto",
    multipole: str = "quad",
    layout: str = "auto",
    far_impl: Optional[str] = None,
) -> torch.Tensor:
    """Barnes-Hut forces [N, D]: build, evaluate, unsort, scale by G·m.

    Counterpart of ``nbody_tpu.ops.grid_tree.barnes_hut_grid`` with the
    same parameters and defaults (θ from ``config``, quadrupole sources,
    far field and batching from :func:`resolve_bh_params`). ``p2p_impl``:
    ``"auto"`` (K6 for fp32 bodies on the card, else the plain near field
    in the bodies' dtype), ``"cuda"`` (K6 in fp32 on any dtype) or
    ``"plain"``. ``layout``: ``"dense"`` (capacity-padded leaves; refuses a
    degenerate capacity), ``"sparse"`` (``ops/sparse_grid.py``: chunked
    targets, windowed near field, O(N) memory on any distribution; its near
    field is plain torch, so no K6 launch), or ``"auto"``: dense, and sparse
    where the capacity guard would trip. The sparse path keeps the resolved
    leaf level and runs ``"hier"`` as ``"local"``: ``far_field_rings`` has
    no hier mode for chunk targets.
    """
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    rp = resolve_bh_params(n, dim, theta, far_impl=far_impl,
                           leaf_level=leaf_level, leaf_batch=leaf_batch,
                           multipole=multipole)
    k, far_impl = rp["k"], rp["far_impl"]
    num_segments, leaf_batch = rp["num_segments"], rp["leaf_batch"]
    leaf_level = rp["leaf_level"]
    if layout not in ("auto", "dense", "sparse"):
        raise ValueError(f"layout must be 'auto', 'dense' or 'sparse', "
                         f"got {layout!r}")

    def sparse():
        from .sparse_grid import barnes_hut_sparse
        return barnes_hut_sparse(
            positions, masses, config, theta=theta, leaf_level=leaf_level,
            multipole=multipole,
            far_impl="local" if far_impl == "hier" else far_impl)

    if layout == "sparse":
        return sparse()
    if capacity is None:
        capacity = compute_capacity(positions, leaf_level)
        if layout == "auto" and dense_layout_degenerate(
                capacity, n, leaf_level, dim):
            return sparse()
        check_grid_capacity(capacity, n, leaf_level, dim, "barnes_hut_grid")
    p2p_impl = _resolve_p2p_impl(p2p_impl, positions.device)
    soft = float(config.softening)

    tree = build_grid_tree(positions, masses, leaf_level, capacity,
                           quad=(multipole == "quad"))
    hier_coeffs = None
    if num_segments > 1 and far_impl == "hier":
        # One downward sweep shared by every segment (defer="gather").
        from .hier_far import hier_far_coeffs
        hier_coeffs = hier_far_coeffs(tree, k, multipole=multipole,
                                      defer="gather")[0]
    acc_sorted = None
    for si in range(num_segments):
        part = grid_tree_accel_sorted(
            tree, k=k, softening=soft, leaf_batch=leaf_batch,
            p2p_impl=p2p_impl, multipole=multipole,
            num_segments=num_segments, segment_index=si, far_impl=far_impl,
            hier_coeffs=hier_coeffs)
        acc_sorted = part if acc_sorted is None else acc_sorted + part
    acc = torch.empty_like(acc_sorted)
    acc[tree.order] = acc_sorted
    return (config.G * masses)[:, None] * acc
