"""Body-sharded trees with locally-essential-tree (LET) exchange.

Port of ``nbody_tpu.parallel.let_tree``. Where ``parallel/sharded_tree.py``
copies every body and the whole tree to each device, here each shard holds
O(N/P + halo) bodies:

1. **Exchange**: each shard Morton-keys its resident bodies against the
   global bounds (:meth:`Mesh.pmin` / :meth:`Mesh.pmax`), buckets them by
   owner (shard p owns the contiguous leaf chunk [p·cc, (p+1)·cc), cc =
   2^(D·L)/P) into fixed-capacity buckets of H rows, and trades the
   buckets with one :meth:`Mesh.all_to_all`. Each shard re-sorts what it
   received: it then holds exactly the bodies of its chunk, in Morton
   order.
2. **Aggregates**: each shard's leaf sums are gathered and reduced up the
   levels into tables that every shard reads (4 floats a cell, plus the
   second moments); that reduction runs once per distinct device.
3. **Far field**: Barnes-Hut's V-list rings (``grid_tree.far_field_rings``)
   or the FMM's P2M, M2M, M2L (rows split over the shards where a level
   has at least P cells), L2L and L2P (``ops/fmm.py``'s phases).
4. **Near field**: neighbours inside the chunk are evaluated locally; the
   foreign ones form a (leaf, neighbour cell) *halo list*, evaluated while
   the owners' packed bodies rotate around the ring
   (:meth:`Mesh.rotate`), one foreign block at a time.

Capacities are never truncated: an exchange bucket or a halo list that
overflows on any shard makes every shard's rows NaN (a dropped body
corrupts every shard's sums). By default H is the exact bucket peak of the
input (one host read, :data:`HOST_READS`) and the halo capacity the exact
geometric peak (:func:`halo_cap_exact`).

What differs from the JAX package, and why:

* ``shard_map`` becomes stages over the mesh's shards, the JAX body's
  collectives between them; ``pcast`` and ``axis_index`` have no
  counterpart (the shard index is the loop's).
* The bucket slices ``dynamic_slice_in_dim(pos_t, bnd[p], H)`` are one
  clamped, masked gather at ``bnd[p] + arange(H)``: no host read per
  bucket. Keys are int64 holding the uint32 Morton values; every argsort is
  stable, every ``searchsorted`` takes the left side.
* ``lax.map`` over leaf batches is a Python loop over batches clamped as
  the grid tier clamps them (``grid_tree.near_batch_plan``), and the pair
  sums run in tiles of :data:`_PAIR_TILE` pairs: eager torch materializes
  what XLA fuses, and each row's sum is the same.
* The near field's geometry (each leaf's neighbour cells inside the chunk,
  the halo list and each halo row's owner) depends on no body, so it is
  computed on the host (:func:`_near_tables`), as the JAX package sizes
  the halo on the host. The local windows are compacted to the in-chunk
  neighbours (masked windows add only zeros), and each ring step evaluates
  only the halo rows of the block it holds, where the JAX program
  evaluates every row at every step under a mask; step 0 (the shard's own
  block) and the rotation after the last step are skipped. A halo list
  over ``halo_cap`` is cut there and poisons, as in the JAX package.
* The bucket peak has no id/weakref memo: torch tensors are mutable.
* A shard count that does not divide 2^(D·L) raises ``ValueError``: the
  JAX package's integer division drops the leaves past P·cc silently.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..ops import fmm
from ..ops.cuda_p2p import p2p_plain
from ..ops.grid_tree import (_clipped_ids, _in_bounds, _neighbor_offsets,
                             _point_mass_accel, _window_rows_raw,
                             auto_leaf_level, cell_coords,
                             check_grid_capacity, compute_capacity,
                             far_field_rings, leaf_window_sums,
                             near_batch_plan, reduce_levels, theta_to_ring)
from ..ops.keys import morton_key_from_coords, quantize
from .mesh import Mesh, make_mesh, pad_to_multiple, shard_bodies
from .sharded_tree import _leaf_level_for

#: Pairs a step of the plain near field evaluates at most, by device type:
#: eager torch materializes the [rows, targets, sources] terms that XLA
#: fuses. On the CPU a tile that stays in cache runs ~3.6× faster than one
#: of 2^25 (f64, 2 threads); on the card a large tile keeps the launches
#: few.
_PAIR_TILE = {"cpu": 1 << 20, "cuda": 1 << 25}

#: Host reads the LET tiers make themselves (the exchange's bucket peak);
#: the capacity scan and the BVH walk count theirs elsewhere.
HOST_READS = {"count": 0}


def _np_morton(coords: np.ndarray, dim: int) -> np.ndarray:
    """Numpy Morton encode (``ops/keys.morton_key_from_coords``) for the
    halo sizing, in uint32."""
    def spread2(x):
        x = x.astype(np.uint32) & 0xFFFF
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    def spread3(x):
        x = x.astype(np.uint32) & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    if dim == 2:
        return (spread2(coords[:, 0]) << 1) | spread2(coords[:, 1])
    return ((spread3(coords[:, 0]) << 2) | (spread3(coords[:, 1]) << 1)
            | spread3(coords[:, 2]))


@functools.lru_cache(maxsize=None)
def halo_cap_exact(dim: int, L: int, cc: int, k: int) -> int:
    """Exact per-shard halo-list peak, a function of the geometry alone.

    The halo list holds every (leaf, neighbour cell) pair whose neighbour
    lies outside the shard's Morton chunk, whatever the bodies, so the
    worst shard's count is computed once in numpy: num_cells × (2k+1)^D
    work, with the JAX package's padded heuristic above 3e8.
    """
    num = 1 << (dim * L)
    nshard = num // cc
    side = 1 << L
    offs = _neighbor_offsets(dim, k)
    if num * len(offs) > 3e8:  # unrealistically deep: padded heuristic
        nnear = len(offs)
        return int(min(cc * nnear, 8 * k * nnear
                       * int(max(cc, 4) ** ((dim - 1) / dim))))
    axes = [np.arange(side, dtype=np.int32)] * dim
    coords = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")],
                      axis=1)
    owner = (_np_morton(coords, dim) // cc).astype(np.int32)
    per_shard = np.zeros(nshard, np.int64)
    for off in offs:
        nb = coords + off[None, :]
        ok = np.all((nb >= 0) & (nb < side), axis=1)
        nb_owner = _np_morton(np.clip(nb, 0, side - 1), dim) // cc
        foreign = ok & (nb_owner != owner)
        per_shard += np.bincount(owner[foreign], minlength=nshard)
    return int(per_shard.max())


def _bounds(mins, maxs):
    """(lo, hi) of the exchange: the reference's 1% padding, in the JAX
    operation order."""
    dt = mins.dtype
    center = 0.5 * (mins + maxs)
    half = (0.5 * (maxs - mins) * torch.tensor(1.01, dtype=dt)
            + torch.tensor(1e-30, dtype=dt))
    return center - half, center + half


def _keys(pos, L, lo, hi):
    return morton_key_from_coords(quantize(pos, L, lo=lo, hi=hi), L)


def exchange_bucket_peak(positions: torch.Tensor, leaf_level: int,
                         nshard: int, rows_per: int) -> int:
    """The exact largest (source shard, owner) bucket of the exchange: its
    bounds and keys on the real bodies, source shard = row // rows_per.
    One host read (:data:`HOST_READS`)."""
    n, dim = positions.shape
    lo, hi = _bounds(positions.min(dim=0).values, positions.max(dim=0).values)
    cc = (1 << (dim * leaf_level)) // nshard
    owner = _keys(positions, leaf_level, lo, hi) // cc
    src = torch.arange(n, device=positions.device) // rows_per
    counts = torch.bincount(src * nshard + owner, minlength=nshard * nshard)
    HOST_READS["count"] += 1
    return int(counts.max())


@dataclasses.dataclass
class Chunk:
    """One shard's bodies after the exchange: the leaves [my0, my0 + cc) of
    the global grid, Morton-sorted, invalid rows (idx < 0) last. The field
    names are :class:`~nbody_tpu_torch.ops.grid_tree.GridTree`'s where they
    mean the same, so the grid tier's far field and the FMM's phases read a
    chunk as they read a tree (``cell_start``/``cell_count`` are indexed by
    chunk-relative leaf)."""

    dim: int
    leaf_level: int
    capacity: int
    my0: int
    cc: int
    lo: torch.Tensor  # [D] global bounds
    cell_sizes: torch.Tensor  # [L+1, D]
    pos_sorted: torch.Tensor  # [PH, D]
    mass_sorted: torch.Tensor  # [PH]
    idx: torch.Tensor  # [PH] input row, −1 on invalid rows
    key: torch.Tensor  # [PH] leaf id, P·cc on invalid rows
    cell_start: torch.Tensor  # [cc]
    cell_count: torch.Tensor  # [cc]
    body_pack: torch.Tensor  # [PH/8, 32]
    overflow: torch.Tensor  # bool, this shard's bucket overflow
    level_pack: Tuple[torch.Tensor, ...] = ()
    level_quad: Tuple[torch.Tensor, ...] = ()

    @property
    def n(self) -> int:
        return self.pos_sorted.shape[0]

    @property
    def num_leaf_cells(self) -> int:
        return 1 << (self.dim * self.leaf_level)

    @property
    def leaf_ids(self) -> torch.Tensor:
        """Each row's leaf, invalid rows clipped to the last leaf."""
        return self.key.clamp(max=self.num_leaf_cells - 1)

    @property
    def valid(self) -> torch.Tensor:
        return self.idx >= 0


def _exchange(mesh: Mesh, pos, mass, idx, *, L, cc, H, capacity):
    """Morton buckets + all_to_all: the shards' :class:`Chunk`\\ s."""
    p = mesh.num_shards
    dim = pos[0].shape[1]
    dt = pos[0].dtype
    big = torch.finfo(dt).max

    def masked(r, fill):
        return torch.where((idx[r] >= 0)[:, None], pos[r],
                           torch.tensor(fill, dtype=dt, device=pos[r].device))

    mins = mesh.pmin(mesh.per_shard(lambda r: masked(r, big).amin(0)))
    maxs = mesh.pmax(mesh.per_shard(lambda r: masked(r, -big).amax(0)))
    bounds = mesh.per_device(lambda r: _bounds(mins[r], maxs[r]))

    def send(r):
        lo, hi = bounds[r]
        dev = pos[r].device
        key = torch.where(idx[r] >= 0, _keys(pos[r], L, lo, hi),
                          torch.tensor(p * cc, device=dev))
        order = torch.argsort(key, stable=True)
        key_s = key[order]
        bnd = torch.searchsorted(
            key_s, torch.arange(p + 1, device=dev) * cc)
        cnt = bnd[1:] - bnd[:-1]
        overflow = (cnt > H).any()
        # Bucket q is rows bnd[q] .. bnd[q] + H − 1 of the sorted bodies;
        # the rows past its count are masked, so the clamp moves only them.
        ar = torch.arange(H, device=dev)
        ok = ar[None, :] < cnt[:, None]  # [P, H]
        rows = order[(bnd[:-1, None] + ar).clamp(max=key_s.shape[0] - 1)]
        sendf = pos[r].new_zeros((p, H, 4))  # packed (pos|0, mass) rows
        sendf[..., :dim] = pos[r][rows] * ok[..., None]
        sendf[..., 3] = mass[r][rows] * ok
        sendi = torch.where(ok, idx[r][rows], torch.full_like(rows, -1))
        return sendf, sendi, overflow

    sent = mesh.per_shard(send)
    recvf = mesh.all_to_all([s[0] for s in sent])
    recvi = mesh.all_to_all([s[1] for s in sent])

    def receive(r):
        lo, hi = bounds[r]
        flatf = recvf[r].reshape(p * H, 4)
        flati = recvi[r].reshape(p * H)
        dev = flatf.device
        rkey = torch.where(flati >= 0, _keys(flatf[:, :dim], L, lo, hi),
                           torch.tensor(p * cc, device=dev))
        o2 = torch.argsort(rkey, stable=True)
        key_s = rkey[o2]
        my0 = r * cc
        starts = torch.searchsorted(key_s, my0 + torch.arange(cc, device=dev))
        ends = torch.cat([starts[1:], (flati >= 0).sum().reshape(1)])
        return Chunk(
            dim=dim, leaf_level=L, capacity=capacity, my0=my0, cc=cc, lo=lo,
            cell_sizes=torch.stack([(hi - lo) / (1 << l)
                                    for l in range(L + 1)]),
            pos_sorted=flatf[o2, :dim], mass_sorted=flatf[o2, 3],
            idx=flati[o2], key=key_s, cell_start=starts,
            cell_count=ends - starts,
            body_pack=flatf[o2].reshape(p * H // 8, 32),
            overflow=sent[r][2])

    return mesh.per_shard(receive)


def _replicated_levels(mesh: Mesh, chunks, quad: bool) -> None:
    """Leaf window sums of each chunk → all_gather → reduced up the levels
    once per device; sets each chunk's ``level_pack`` / ``level_quad``."""
    c0 = chunks[0]
    sums = mesh.per_shard(lambda r: leaf_window_sums(
        chunks[r].body_pack, chunks[r].cell_start,
        chunks[r].cell_start + chunks[r].cell_count,
        capacity=c0.capacity, ncells=c0.cc, dim=c0.dim, quad=quad))
    m_l = mesh.all_gather([s[0] for s in sums])
    mx_l = mesh.all_gather([s[1] for s in sums])
    S_l = mesh.all_gather([s[2] for s in sums]) if quad \
        else [None] * mesh.num_shards
    levels = mesh.per_device(lambda r: reduce_levels(
        m_l[r], mx_l[r], S_l[r], dim=c0.dim, L=c0.leaf_level,
        dtype=m_l[r].dtype))
    for c, lv in zip(chunks, levels):
        c.level_pack, c.level_quad = tuple(lv[2]), tuple(lv[3])


def _batches(chunk: Chunk, leaf_batch: int):
    """The chunk's leaf ids (global) in batches of ``leaf_batch``."""
    cells = chunk.my0 + torch.arange(chunk.cc,
                                     device=chunk.pos_sorted.device)
    return cells.split(leaf_batch)


def _windows(chunk: Chunk, rel):
    return _window_rows_raw(chunk.body_pack, chunk.cell_start,
                            chunk.cell_count, chunk.capacity, rel)


def _near_tables(dim: int, L: int, cc: int, my0: int, k: int,
                 halo_cap: int):
    """The static geometry of a chunk's near field, computed on the host
    (it depends on no body):

    * ``local`` [cc, m], ``local_ok``: each leaf's in-bounds neighbour
      cells inside the chunk (chunk-relative), compacted to the front in
      ring order; m ≤ min((2k+1)^D, cc) is the largest count;
    * ``h_leaf``, ``h_nb`` [HC]: the halo list, every (leaf, foreign
      neighbour cell) pair in (leaf, ring) order, at most ``halo_cap`` of
      them, and ``overflow`` when there were more;
    * ``owner_rows``: per shard q, the halo rows whose cell q owns.
    """
    cells = my0 + torch.arange(cc)
    nb_xy = cell_coords(cells, dim)[:, None, :] + torch.as_tensor(
        _neighbor_offsets(dim, k))[None, :, :]
    nb_ids = _clipped_ids(nb_xy, L, dim, (cc, -1))
    ok = _in_bounds(nb_xy, L)
    mine = ok & (nb_ids >= my0) & (nb_ids < my0 + cc)
    order = torch.argsort((~mine).to(torch.int32), dim=1, stable=True)
    m = max(1, int(mine.sum(1).max()))
    local = (nb_ids - my0).clamp(0, cc - 1).gather(1, order)[:, :m]
    local_ok = mine.gather(1, order)[:, :m]
    entries = torch.nonzero((ok & ~mine).reshape(-1))[:, 0]
    overflow = entries.numel() > halo_cap
    entries = entries[:halo_cap]
    h_leaf = entries // nb_ids.shape[1]
    h_nb = nb_ids.reshape(-1)[entries]
    nshard = (1 << (dim * L)) // cc
    owner_rows = [torch.nonzero(h_nb // cc == q)[:, 0] for q in range(nshard)]
    return local, local_ok, h_leaf, h_nb, owner_rows, overflow


def _near_field(mesh: Mesh, chunks, *, k, softening, halo_cap, leaf_batch):
    """Local + halo-ring P2P of every chunk: (near acceleration in window
    layout [cc, TWR, D], halo overflow) per shard. The pair sums are
    ``cuda_p2p.p2p_plain``'s, in tiles of :data:`_PAIR_TILE` pairs; each
    ring step evaluates only the halo rows of the block it holds."""
    p = mesh.num_shards
    c0 = chunks[0]
    dim, L, cc = c0.dim, c0.leaf_level, c0.cc
    tile = _PAIR_TILE[mesh.device_type]

    def tables(r):
        dev = chunks[r].pos_sorted.device
        t = _near_tables(dim, L, cc, r * cc, k, halo_cap)
        return ([x.to(dev) for x in t[:4]], [x.to(dev) for x in t[4]],
                torch.tensor(t[5], device=dev))

    tabs = mesh.per_shard(tables)

    def src4(sb, keep):
        """Window rows [..., W, 4] as packed sources, masked rows mass 0."""
        return torch.cat([sb[..., :3], (sb[..., 3] * keep)[..., None]], -1)

    def local(r):
        c = chunks[r]
        nb, nb_ok = tabs[r][0][:2]
        out = []
        for rel in torch.arange(cc, device=nb.device).split(leaf_batch):
            tb, _, _ = _windows(c, rel)
            sb, _, svalid = _windows(c, nb[rel])
            out.append(p2p_plain(
                tb[..., :dim], src4(sb, svalid & nb_ok[rel][..., None])
                .reshape(rel.shape[0], -1, 4), softening, tile))
        return torch.cat(out)

    acc = mesh.per_shard(local)
    h_tpos = mesh.per_shard(lambda r: _windows(
        chunks[r], tabs[r][0][2])[0][..., :dim])
    hacc = [torch.zeros_like(t) for t in h_tpos]
    blk = [(c.body_pack, c.cell_start, c.cell_count) for c in chunks]

    def step(r, s):
        q = (r - s) % p  # the owner of the block now held
        rows = tabs[r][1][q]
        if rows.numel():
            sb, _, svalid = _window_rows_raw(*blk[r], c0.capacity,
                                             tabs[r][0][3][rows] - q * cc)
            hacc[r][rows] = p2p_plain(h_tpos[r][rows], src4(sb, svalid),
                                      softening, tile)

    # Step 0 holds the shard's own block, which no halo pair reads.
    for s in range(1, p):
        blk = mesh.rotate(blk)
        mesh.per_shard(lambda r: step(r, s))

    def fold(r):
        out = acc[r].index_add(0, tabs[r][0][2], hacc[r])
        return out, tabs[r][2]

    return mesh.per_shard(fold)


def _windows_to_local(acc_win, chunk: Chunk):
    """Window layout [cc, TWR, D] → the chunk's sorted rows (a gather)."""
    twr = acc_win.shape[1]
    rel = (chunk.key - chunk.my0).clamp(0, chunk.cc - 1)
    slot = (torch.arange(chunk.n, device=rel.device)
            - (chunk.cell_start[rel] // 8) * 8)
    return acc_win.reshape(-1, acc_win.shape[2])[
        rel * twr + slot.clamp(0, twr - 1)]


def _finish(mesh: Mesh, chunks, acc, overflow, config: GravityConfig):
    """G·m scaling, invalid rows zeroed, every shard NaN where any shard
    overflowed: forces [PH, D] per shard."""
    flag = mesh.pmax([o.to(torch.int32) for o in overflow])

    def one(r):
        c = chunks[r]
        f = (config.G * c.mass_sorted)[:, None] * acc[r]
        f = torch.where(c.valid[:, None], f, torch.zeros_like(f))
        return torch.where(flag[r] > 0, torch.full_like(f, float("nan")), f)

    return mesh.per_shard(one)


def _bh_shards(mesh: Mesh, chunks, *, k, softening, halo_cap, leaf_batch,
               multipole, far_impl):
    """Per shard: LET Barnes-Hut accelerations of the chunk's rows."""
    _replicated_levels(mesh, chunks, quad=(multipole == "quad"))

    def far(r):
        c = chunks[r]
        return torch.cat([far_field_rings(
            c, cells, _windows(c, cells - c.my0)[0][..., :c.dim], k=k,
            multipole=multipole, far_impl=far_impl)
            for cells in _batches(c, leaf_batch)])

    far_win = mesh.per_shard(far)
    near = _near_field(mesh, chunks, k=k, softening=softening,
                       halo_cap=halo_cap, leaf_batch=leaf_batch)
    acc = mesh.per_shard(lambda r: _windows_to_local(
        far_win[r] + near[r][0], chunks[r]))
    return acc, [c.overflow | nr[1] for c, nr in zip(chunks, near)]


def _fmm_shards(mesh: Mesh, chunks, *, k, softening, halo_cap, leaf_batch,
                order):
    """Per shard: LET FMM accelerations of the chunk's rows. P2M over each
    chunk, gathered; M2M, coarse M2L and L2L once per device; M2L rows
    split over the shards where a level has at least P cells; L2P over the
    chunk's own rows."""
    p = mesh.num_shards
    c0 = chunks[0]
    dim, L, nl = c0.dim, c0.leaf_level, c0.num_leaf_cells
    fmm._check_matmul_precision(c0.pos_sorted)
    tables = mesh.per_device(lambda r: fmm._tables(
        dim, order, c0.pos_sorted.dtype, chunks[r].pos_sorted.device))

    def p2m(r):
        c, Tt = chunks[r], tables[r][0]
        half = fmm._leaf_half(c)
        out = []
        for cells in _batches(c, leaf_batch):
            tb, _, valid = _windows(c, cells - c.my0)
            out.append(fmm._anterpolate(
                tb[..., :dim], tb[..., 3] * valid, valid,
                fmm._cell_centers(c, cells), half, order, Tt))
        return torch.cat(out)

    W_leaf = mesh.all_gather(mesh.per_shard(p2m))
    W = mesh.per_device(lambda r: fmm._m2m(W_leaf[r], tables[r][1], dim, L))
    Lc = [dict() for _ in range(p)]
    if L >= 2:
        ops = mesh.per_device(lambda r: fmm._m2l_operators(chunks[r], order,
                                                           k))
        for l in range(2, L + 1):
            ncells = 1 << (dim * l)
            if ncells >= p:
                mc = ncells // p
                rows = mesh.all_gather(mesh.per_shard(
                    lambda r: fmm._m2l_level(chunks[r], W[r][l], ops[r], l,
                                             r * mc, mc)))
            else:
                rows = mesh.per_device(lambda r: fmm._m2l_level(
                    chunks[r], W[r][l], ops[r], l))
            for r in range(p):
                Lc[r][l] = rows[r]
    L_leaf = mesh.per_device(lambda r: fmm._l2l(Lc[r], tables[r][1], L, nl,
                                                W_leaf[r]))

    def l2p(r):
        # Invalid rows are pinned to their (clipped) leaf's centre: y = 0.
        c = chunks[r]
        pinned = torch.where(c.valid[:, None], c.pos_sorted,
                             fmm._cell_centers(c, c.leaf_ids))
        return fmm._l2p(dataclasses.replace(c, pos_sorted=pinned),
                        L_leaf[r], order, tables[r][0])

    far = mesh.per_shard(l2p)
    near = _near_field(mesh, chunks, k=k, softening=softening,
                       halo_cap=halo_cap, leaf_batch=leaf_batch)
    acc = mesh.per_shard(lambda r: far[r] + _windows_to_local(near[r][0],
                                                              chunks[r]))
    return acc, [c.overflow | nr[1] for c, nr in zip(chunks, near)]


def _leaf_level(mesh: Mesh, n: int, dim: int, k: int,
                leaf_level: Optional[int]) -> int:
    """The leaf level (``auto_leaf_level`` by default), raised until every
    shard owns a leaf; a shard count that does not divide 2^(D·L)
    raises."""
    L = _leaf_level_for(mesh, auto_leaf_level(n, dim, k=k)
                        if leaf_level is None else leaf_level, dim)
    if (1 << (dim * L)) % mesh.num_shards:
        raise ValueError(f"{mesh.num_shards} shards do not split the "
                         f"{1 << (dim * L)} leaves of level {L} evenly: the "
                         f"LET tiers need a power-of-two shard count")
    return L


def bucket_rows(positions, leaf_level: int, nshard: int, n_pad: int,
                bucket_headroom: Optional[float]) -> int:
    """H, the exchange bucket's rows: the exact peak (one host read), or
    ``bucket_headroom``·N/P² where given; a multiple of 8, at least 8."""
    n = positions.shape[0]
    if bucket_headroom is None:
        peak = exchange_bucket_peak(positions, leaf_level, nshard,
                                    n_pad // nshard)
    else:
        peak = math.ceil(bucket_headroom * n / nshard ** 2)
    return pad_to_multiple(max(8, peak), 8)


def shard_padded(mesh: Mesh, positions, masses):
    """Pad to a multiple of P·8 rows (bodies at 2e9, mass 0, idx −1: never
    shipped by the exchange) and split over the mesh: (pos, mass, idx)."""
    n, dim = positions.shape
    n_pad = pad_to_multiple(n, mesh.num_shards * 8)
    pad = n_pad - n
    dev = positions.device
    pos = torch.cat([positions, positions.new_full((pad, dim), 2.0e9)])
    mass = torch.cat([masses, masses.new_zeros(pad)])
    idx = torch.cat([torch.arange(n, device=dev),
                     torch.full((pad,), -1, dtype=torch.int64, device=dev)])
    return shard_bodies(mesh, pos, mass, idx)


def materialize(forces, idx, n: int, like: torch.Tensor) -> torch.Tensor:
    """The shards' (forces, idx) rows back in input order on ``like``'s
    device: a scatter-add into N + 1 rows whose last row (the invalid
    rows') is dropped."""
    out = like.new_zeros((n + 1, like.shape[1]))
    for f, i in zip(forces, idx):
        out.index_add_(0, torch.where(i >= 0, i, n).to(like.device),
                       f.to(like.device))
    return out[:n]


def _let_launch(shard_fn, positions, masses, config, mesh, k, leaf_level,
                capacity, bucket_headroom, halo_cap, leaf_batch):
    """The scaffold the LET Barnes-Hut and FMM share: capacities, padding,
    exchange, the tier's stages, materialization."""
    mesh = make_mesh() if mesh is None else mesh
    mesh.check(positions, masses)
    p = mesh.num_shards
    n, dim = positions.shape
    L = _leaf_level(mesh, n, dim, k, leaf_level)
    cc = (1 << (dim * L)) // p
    if capacity is None:
        capacity = compute_capacity(positions, L)
        check_grid_capacity(capacity, n, L, dim, "let_tree")
    n_pad = pad_to_multiple(n, p * 8)
    H = bucket_rows(positions, L, p, n_pad, bucket_headroom)
    if halo_cap is None:
        halo_cap = min((2 * k + 1) ** dim * cc, pad_to_multiple(
            max(8, halo_cap_exact(dim, L, cc, k)), 8))
    pos, mass, idx = shard_padded(mesh, positions, masses)
    chunks = _exchange(mesh, pos, mass, idx, L=L, cc=cc, H=H,
                       capacity=capacity)
    # The grid tier's batch: at most the chunk's leaves, and a near-field
    # source tensor of ~1 GB.
    leaf_batch = near_batch_plan(chunks[0], k, leaf_batch, num_shards=p)[0]
    acc, overflow = shard_fn(mesh, chunks, k=k,
                             softening=float(config.softening),
                             halo_cap=halo_cap, leaf_batch=leaf_batch)
    forces = _finish(mesh, chunks, acc, overflow, config)
    return materialize(forces, [c.idx for c in chunks], n, positions)


def let_barnes_hut(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    theta: Optional[float] = None,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    bucket_headroom: Optional[float] = None,
    halo_cap: Optional[int] = None,
    leaf_batch: int = 512,
    multipole: str = "quad",
    far_impl: str = "local",
) -> torch.Tensor:
    """Barnes-Hut forces [N, D] with body-sharded LET distribution.

    The JAX package's parameters and defaults (θ from ``config``,
    quadrupole sources, the far field through a leaf-centred local
    expansion where ``grid_tree.far_field_rings`` allows it). Each shard
    holds O(N/P + halo) bodies; the replicated state is the per-level cell
    summaries. Overflow poisons every row with NaN (module docstring):
    raise ``bucket_headroom`` or ``halo_cap`` for clustered inputs.
    """
    theta = config.theta if theta is None else theta
    return _let_launch(
        functools.partial(_bh_shards, multipole=multipole,
                          far_impl=far_impl),
        positions, masses, config, mesh, theta_to_ring(theta), leaf_level,
        capacity, bucket_headroom, halo_cap, leaf_batch)


def let_fmm(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    order: int = 5,
    ring: int = 1,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    bucket_headroom: Optional[float] = None,
    halo_cap: Optional[int] = None,
    leaf_batch: int = 512,
) -> torch.Tensor:
    """Black-box FMM forces [N, D] with body-sharded LET distribution (the
    JAX package's parameters and defaults). The FMM's products refuse TF32
    on CUDA tensors, as ``fmm_forces`` does."""
    return _let_launch(
        functools.partial(_fmm_shards, order=order), positions, masses,
        config, mesh, ring, leaf_level, capacity, bucket_headroom, halo_cap,
        leaf_batch)
