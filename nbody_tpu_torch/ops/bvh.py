"""Hilbert radix BVH tier: a binary radix tree built on the device and a
level-synchronous frontier walk, in plain PyTorch.

Port of ``nbody_tpu.ops.bvh``. The tree and the walk are the JAX package's:

* **Build** (:func:`build_bvh`): exact Hilbert keys (``ops/keys.py``),
  left-aligned and stably sorted; the Karras (2012) radix tree found as the
  Cartesian tree of adjacent-key common-prefix lengths by two
  all-nearest-smaller-values descents over a range-min table, then
  renumbered into Karras order; per-node mass and COM from prefix sums, the
  exact AABB extent from a sparse range-min/max table, and (``quad=True``)
  mass, COM and COM-centred second moments from a segment tree of aligned
  power-of-two blocks combined pairwise; everything packed into one row
  table per node and one per body.
* **Walk** (:func:`bvh_accel_sorted`): each group of ``group_size``
  contiguous sorted bodies keeps a frontier of candidate nodes; one
  iteration classifies it (group MAC → monopole or quadrupole at each
  body, or a local expansion at the group centre with
  ``far_impl="local"``; ≤ ``leaf_size`` bodies → the near bag; otherwise
  both children), and pass 2 evaluates the near bag over contiguous body
  windows with the reference's d² < 1e-10 pair guard. Capacity overflow
  poisons the group with NaN.
* **Driver** (:func:`bvh_forces`): one evaluation, one host read-back of the
  high-water counts, and a re-walk of only the overflowed groups at raised
  capacities, seeded from ``caps_state``.
* **Spans** (:mod:`..utils.profiling`, off by default): ``bvh.build``, a
  batch's frontier loop ``bvh.frontier`` (counter ``bvh.walk_iters``), its
  pass 2 ``bvh.near``, and each escalation round ``bvh.rewalk`` with its
  read-back (counters ``bvh.escalations``, ``bvh.rewalk_groups``: the
  padded subset's groups). The re-walks' loops and passes 2 count under
  ``bvh.frontier`` and ``bvh.near`` too.

What differs from the JAX package, and why:

* Keys and tree indices are int64 (the keys hold the uint32 values, as in
  ``ops/keys.py``); ``_clz32`` is built from exact shifts and compares (torch
  has no clz), and the AABB windows use the exact integer floor(log2) of a
  node's body count where the JAX package takes an fp32 ``log2`` (equal
  below 2^20 − 1 bodies; at 2^k − 1 with k ≥ 20 the JAX value is one too
  large, which only widens its AABB).
* ``while_loop`` and ``lax.cond`` become Python loops: the frontier and the
  near bag are sort-compacted, so chunk c of a batch holds work iff the
  batch's largest row count exceeds c · chunk. One read-back a walk
  iteration (:data:`HOST_READS`) gives both the loop condition and the
  number of chunks to run, with the JAX package's skip semantics; pass 2
  takes its chunk count from the same read-back. The frontier and the near
  bag are held as wide as that count in whole chunks, not at their
  capacities (the columns past it are empty in the JAX package's buffers
  too): an escalated near capacity of ~1e5 would otherwise be sorted
  whole in every iteration.
* Gathers clamp their indices explicitly: torch raises on an out-of-range
  index where a JAX gather wraps once and clamps (pass 2's window start is
  negative for N < ``leaf_size``). The masks zero every row a clamp moves.
* Eager torch materializes what XLA fuses, so pass 2 runs its groups in
  sub-batches of at most :data:`_NEAR_ELEMS` pair elements; per-row results
  do not depend on the sub-batch.
* ``lax.map`` over batches and quad-query blocks is a Python loop over the
  same batches and blocks.
* Sharding takes ``shard_index`` and ``num_shards`` where the JAX package
  takes ``shard_axis`` under ``shard_map``: shard r walks groups [r·gp,
  (r+1)·gp), gp = ⌈groups/P⌉, and returns its rows in an [N, D] partial,
  zero elsewhere, for the caller to add. The JAX program pads the groups
  to gp·P with groups at the origin whose rows lie past N; the port walks
  only the real groups. ``varying_axis`` (a ``shard_map`` typing detail)
  has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..utils.profiling import count, span
from .brute_force import _DIST2_GUARD
from .grid_tree import _quad_pairs
from .keys import MAX_BITS, hilbert_key

_INVALID = 2_147_483_647  # int32 max: sorts after every node id
_MASK32 = 0xFFFFFFFF
# Pair elements ([groups, G, sources]) of one pass-2 sub-batch: 256 MiB a
# temporary in fp32.
_NEAR_ELEMS = 1 << 26
# Host read-backs (device → host syncs) made by the walk and the driver.
HOST_READS = {"count": 0}


def _read(t: torch.Tensor) -> list:
    HOST_READS["count"] += 1
    return t.tolist()


@dataclasses.dataclass(frozen=True)
class BVHTree:
    """Flattened radix BVH over Hilbert-sorted bodies (unified node space:
    ids 0..N-2 internal, N-1..2N-2 single-body leaves). Index fields are
    int64, float fields keep the bodies' dtype."""

    key_bits: int

    order: torch.Tensor  # [N] sorted slot -> original index
    pos_sorted: torch.Tensor  # [N, D]
    mass_sorted: torch.Tensor  # [N]

    range_l: torch.Tensor  # [2N-1] first sorted body of node
    range_r: torch.Tensor  # [2N-1] last sorted body of node
    left: torch.Tensor  # [2N-1] left child (unified id; leaves: self)
    right: torch.Tensor  # [2N-1] right child (unified id; leaves: self)
    node_mass: torch.Tensor  # [2N-1]
    node_com: torch.Tensor  # [2N-1, D]
    node_size: torch.Tensor  # [2N-1] exact AABB max extent

    # node_table[v] = [l, r, left, right, size, mass, com..., quad...] in
    # the bodies' dtype (node ids < 2^24 are exact in fp32: N <= 2^23 is
    # asserted); body_table[b] = [x, y, z|0, mass].
    node_table: torch.Tensor  # [2N-1, 8|12 mono; 12|16 quad]
    body_table: torch.Tensor  # [N, 4]

    @property
    def n(self) -> int:
        return self.pos_sorted.shape[0]


def bvh_tree_from_numpy(fields, device) -> BVHTree:
    """A :class:`BVHTree` from a mapping of field name → numpy array (an
    int for ``key_bits``), e.g. the fields of a JAX ``BVHTree`` passed
    through ``np.asarray``. Integer arrays become int64, floats keep their
    dtype."""
    def conv(a):
        a = np.array(a)  # a writable copy: JAX's arrays are read-only
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device)

    return BVHTree(**{
        f.name: int(fields[f.name]) if f.name == "key_bits"
        else conv(fields[f.name]) for f in dataclasses.fields(BVHTree)})


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values held in int64 (32 for 0), by a
    binary search of exact shifts and compares."""
    y = x & _MASK32
    n = torch.zeros_like(y)
    for s in (16, 8, 4, 2, 1):
        top_zero = (y >> (32 - s)) == 0
        n = n + top_zero * s
        y = torch.where(top_zero, (y << s) & _MASK32, y)
    return n + (y == 0)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(x)) of positive uint32 values held in int64."""
    return 31 - _clz32(x)


def _delta(keys, idx, i, j, n):
    """Common-prefix length of (key, index) pairs at i and j; −1 out of
    range. Duplicate keys are told apart by index bits (Karras §4)."""
    valid = (j >= 0) & (j < n)
    j_c = j.clamp(0, n - 1)
    kx = keys[i] ^ keys[j_c]
    ix = idx[i] ^ idx[j_c]
    d = torch.where(kx != 0, _clz32(kx), 32 + _clz32(ix))
    return torch.where(valid, d, torch.full_like(d, -1))


def _dd(d, qpairs):
    return torch.stack([d[..., a] * d[..., b] for a, b in qpairs], dim=-1)


def build_bvh(positions: torch.Tensor, masses: torch.Tensor, key_bits: int,
              quad: bool = False) -> BVHTree:
    """The radix BVH of ``positions`` [N, D] on their device (see the
    module docstring; ``bvh.py:112-399`` of the JAX package)."""
    n, dim = positions.shape
    dev = positions.device
    dt = positions.dtype
    keys = hilbert_key(positions, bits=key_bits // dim)
    # Left-align keys so clz of the XOR measures the true common prefix.
    keys = (keys << (32 - key_bits)) & _MASK32
    # Stable: equal keys keep index order, which the tiebreak bits assume.
    order = torch.argsort(keys, stable=True)
    keys_s = keys[order]
    pos_s = positions[order]
    mass_s = masses[order]
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    # Radix structure: node g (a gap between adjacent sorted bodies) covers
    # the bodies between the nearest gaps with a smaller delta on each
    # side, found by two binary descents over a range-min table.
    i = idx[:n - 1]
    Dg = _delta(keys_s, idx, i, i + 1, n)  # [n-1], all distinct
    m = n - 1
    K = max(1, math.ceil(math.log2(max(m, 2)))) + 1
    # tab[k][j] = min(D[j .. j+2^k-1]) (out of range → int32 max)
    tab = [Dg]
    for kk in range(1, K):
        sh = 1 << (kk - 1)
        prev = tab[-1]
        tab.append(torch.minimum(prev, torch.cat([
            prev[sh:], torch.full((sh,), _INVALID, dtype=torch.int64,
                                  device=dev)])))

    # Left: smallest p with D[p..g-1] all >= D[g]; range_l[g] = p.
    p = i
    for kk in range(K - 1, -1, -1):
        start = p - (1 << kk)
        ok = (start >= 0) & (tab[kk][start.clamp(min=0)] >= Dg)
        p = torch.where(ok, start.clamp(min=0), p)
    lo = p
    # Right: largest q with D[g+1..q] all >= D[g]; range_r = q capped.
    q = i + 1
    for kk in range(K - 1, -1, -1):
        ok = (q + (1 << kk) - 1 <= m - 1) & \
            (tab[kk][q.clamp(max=max(m - 1, 0))] >= Dg)
        q = torch.where(ok, q + (1 << kk), q)
    hi = q.clamp(max=n - 1)

    # Karras order: a node's id is the range end adjacent to its parent's
    # split gap, the enclosing smaller-delta gap with the larger delta.
    # The ids are a permutation of 0..m-1, so the scatter is one-to-one.
    minus1 = torch.full_like(lo, -1)
    d_lo = torch.where(lo > 0, Dg[(lo - 1).clamp(min=0)], minus1)
    d_hi = torch.where(hi < n - 1, Dg[hi.clamp(max=max(m - 1, 0))], minus1)
    kid = torch.where(d_hi > d_lo, hi, lo)
    unpacked = torch.zeros((max(m, 1), 3), dtype=torch.int64, device=dev)
    unpacked[kid] = torch.stack([lo, hi, i], dim=1)
    lo, hi, gamma = unpacked[:m, 0], unpacked[:m, 1], unpacked[:m, 2]
    # Unified ids: internal node k -> k, leaf body b -> (n-1) + b.
    left_child = torch.where(lo == gamma, (n - 1) + gamma, gamma)
    right_child = torch.where(hi == gamma + 1, (n - 1) + gamma + 1,
                              gamma + 1)

    leaf_ids = (n - 1) + idx
    range_l = torch.cat([lo, idx])
    range_r = torch.cat([hi, idx])
    left = torch.cat([left_child, leaf_ids])
    right = torch.cat([right_child, leaf_ids])

    # Mass / COM per node from prefix sums over the contiguous range; the
    # mass clamped at 0 and massless nodes centred on their first body
    # (an fp32 cumsum difference can round one body's mass to 0).
    cmass = torch.cat([torch.zeros((1,), dtype=dt, device=dev),
                       torch.cumsum(mass_s, 0)])
    cmpos = torch.cat([torch.zeros((1, dim), dtype=dt, device=dev),
                       torch.cumsum(mass_s[:, None] * pos_s, 0)])
    node_mass = (cmass[range_r + 1] - cmass[range_l]).clamp(min=0.0)
    node_mx = cmpos[range_r + 1] - cmpos[range_l]
    node_com = torch.where(
        (node_mass > 0)[:, None],
        node_mx / node_mass.clamp(min=1e-30)[:, None], pos_s[range_l])

    # Exact AABB extent: a range [l, r] is the union of the two aligned
    # windows of width 2^k at l and r+1-2^k, k = floor(log2(count)).
    K = max(1, math.ceil(math.log2(max(n, 2)))) + 1
    big = torch.finfo(dt).max
    mn_tab = torch.empty((K, n, dim), dtype=dt, device=dev)
    mx_tab = torch.empty((K, n, dim), dtype=dt, device=dev)
    mn_tab[0] = pos_s
    mx_tab[0] = pos_s
    for kk in range(1, K):
        sh = 1 << (kk - 1)
        pad = torch.full((sh, dim), big, dtype=dt, device=dev)
        torch.minimum(mn_tab[kk - 1], torch.cat([mn_tab[kk - 1, sh:], pad]),
                      out=mn_tab[kk])
        torch.maximum(mx_tab[kk - 1], torch.cat([mx_tab[kk - 1, sh:], -pad]),
                      out=mx_tab[kk])
    klog = _floor_log2(range_r - range_l + 1).clamp(0, K - 1)
    hi_start = range_r + 1 - (1 << klog)
    flat_mn = mn_tab.reshape(K * n, dim)
    flat_mx = mx_tab.reshape(K * n, dim)
    aabb_min = torch.minimum(flat_mn[klog * n + range_l],
                             flat_mn[klog * n + hi_start])
    aabb_max = torch.maximum(flat_mx[klog * n + range_l],
                             flat_mx[klog * n + hi_start])
    del mn_tab, mx_tab, flat_mn, flat_mx
    node_size = (aabb_max - aabb_min).amax(dim=-1)

    node_quad = None
    if quad:
        node_mass, node_com, node_quad = _quad_moments(pos_s, mass_s, lo, hi)

    # Packed hot-path tables, in the bodies' dtype.
    if dt == torch.float32 and n > (1 << 23):
        raise ValueError("f32-packed node indices require N <= 8M")
    nq = len(_quad_pairs(dim))
    width = (12 if dim == 2 else 16) if quad else (8 if dim == 2 else 12)
    node_table = torch.zeros((2 * n - 1, width), dtype=dt, device=dev)
    node_table[:, 0] = range_l.to(dt)
    node_table[:, 1] = range_r.to(dt)
    node_table[:, 2] = left.to(dt)
    node_table[:, 3] = right.to(dt)
    node_table[:, 4] = node_size
    node_table[:, 5] = node_mass
    node_table[:, 6:6 + dim] = node_com
    if quad:
        node_table[:, 6 + dim:6 + dim + nq] = node_quad
    body_table = torch.zeros((n, 4), dtype=dt, device=dev)
    body_table[:, :dim] = pos_s
    body_table[:, 3] = mass_s

    return BVHTree(
        key_bits=key_bits, order=order, pos_sorted=pos_s, mass_sorted=mass_s,
        range_l=range_l, range_r=range_r, left=left, right=right,
        node_mass=node_mass, node_com=node_com, node_size=node_size,
        node_table=node_table, body_table=body_table)


def _quad_moments(pos_s, mass_s, lo, hi):
    """Mass, COM and COM-centred second moments of every node, from a
    segment tree of aligned power-of-two blocks (pairwise parallel-axis
    combine, no prefix sums: raw moments cancel in fp32 at 1e7-scale
    coordinates). Each internal node [lo, hi] takes its ≤ 2 covering
    blocks a level, summed about its first body, then recentres once."""
    n, dim = pos_s.shape
    dt, dev = pos_s.dtype, pos_s.device
    qpairs = _quad_pairs(dim)
    nq = len(qpairs)
    K = max(1, math.ceil(math.log2(max(n, 2))))
    P = 1 << K
    pad = P - n

    m_k = torch.cat([mass_s, torch.zeros((pad,), dtype=dt, device=dev)])
    c_k = torch.cat([pos_s, pos_s[-1:].expand(pad, dim)])
    S_k = torch.zeros((P, nq), dtype=dt, device=dev)
    tabs = [torch.cat([m_k[:, None], c_k, S_k], dim=-1)]
    for _ in range(K):
        mp = m_k.reshape(-1, 2)
        cp = c_k.reshape(-1, 2, dim)
        Sp = S_k.reshape(-1, 2, nq)
        m_k = mp[:, 0] + mp[:, 1]
        mx = mp[:, 0, None] * cp[:, 0] + mp[:, 1, None] * cp[:, 1]
        c_k = torch.where((m_k > 0)[:, None],
                          mx / m_k.clamp(min=1e-30)[:, None], cp[:, 0])
        S_k = (Sp[:, 0] + mp[:, 0, None] * _dd(cp[:, 0] - c_k, qpairs)
               + Sp[:, 1] + mp[:, 1, None] * _dd(cp[:, 1] - c_k, qpairs))
        tabs.append(torch.cat([m_k[:, None], c_k, S_k], dim=-1))
    offs = np.cumsum([0] + [t.shape[0] for t in tabs])[:-1].tolist()
    tab = torch.cat(tabs, dim=0)  # [2P-1, 1+D+nq]
    del tabs
    last = tab.shape[0] - 1

    # Blocks of 2^18 nodes bound the per-level gather temporaries.
    nb_int = n - 1
    B = min(1 << 18, max(1, nb_int))
    M_parts, Pm_parts, Sa_parts = [], [], []
    for b0 in range(0, nb_int, B):
        lo_k = lo[b0:b0 + B]
        hi_k = hi[b0:b0 + B] + 1
        c_ref = pos_s[lo_k]
        rows = lo_k.shape[0]
        M = torch.zeros((rows,), dtype=dt, device=dev)
        Pm = torch.zeros((rows, dim), dtype=dt, device=dev)
        Sa = torch.zeros((rows, nq), dtype=dt, device=dev)
        for k in range(K + 1):
            c1 = (lo_k < hi_k) & ((lo_k & 1) == 1)
            i1 = offs[k] + lo_k
            lo_k = lo_k + c1.long()
            c2 = (lo_k < hi_k) & ((hi_k & 1) == 1)
            hi_k = hi_k - c2.long()
            i2 = offs[k] + hi_k
            for cond, ib in ((c1, i1), (c2, i2)):
                row = tab[ib.clamp(0, last)]
                mb = torch.where(cond, row[:, 0], 0.0)
                d = torch.where(cond[:, None], row[:, 1:1 + dim] - c_ref, 0.0)
                M = M + mb
                Pm = Pm + mb[:, None] * d
                Sa = (Sa + torch.where(cond[:, None], row[:, 1 + dim:], 0.0)
                      + mb[:, None] * _dd(d, qpairs))
            lo_k = lo_k >> 1
            hi_k = hi_k >> 1
        M_parts.append(M)
        Pm_parts.append(Pm)
        Sa_parts.append(Sa)
    empty = torch.zeros((0,), dtype=dt, device=dev)
    M = torch.cat(M_parts) if M_parts else empty
    Pm = torch.cat(Pm_parts) if Pm_parts else empty.reshape(0, dim)
    Sa = torch.cat(Sa_parts) if Sa_parts else empty.reshape(0, nq)
    c_ref = pos_s[lo]

    dcom = Pm / M.clamp(min=1e-30)[:, None]
    com_int = torch.where((M > 0)[:, None], c_ref + dcom, c_ref)
    S_int = Sa - M[:, None] * _dd(dcom, qpairs)
    return (torch.cat([M, mass_s]), torch.cat([com_int, pos_s]),
            torch.cat([S_int, torch.zeros((n, nq), dtype=dt, device=dev)]))


def _far_inline(acc, nt, nmass, com, pos_g, mask, soft2, multipole, qpairs):
    """Far field of a frontier chunk at each member body: monopole, or
    monopole + quadrupole in ``grid_tree._quad_cell_accel``'s normalized
    form. ``mask`` [B, 1, Wc] selects the nodes evaluated here."""
    dim = pos_g.shape[-1]
    fdiffs = [com[:, None, :, d] - pos_g[:, :, None, d] for d in range(dim)]
    fd2 = fdiffs[0] * fdiffs[0]
    for fd in fdiffs[1:]:
        fd2 = fd2 + fd * fd
    finv = torch.rsqrt(fd2 + soft2)
    if multipole == "quad":
        Sq = nt[..., 6 + dim:6 + dim + len(qpairs)]
        # A leaf's COM can equal a group body's position exactly; 0·inf
        # would leak NaN through the direction even under the mask.
        uq = torch.where(fd2 < _DIST2_GUARD, 0.0, finv)
        u2 = uq * uq
        ndir = [fd * uq for fd in fdiffs]
        s_hat = {p: Sq[..., i][:, None, :] * u2
                 for i, p in enumerate(qpairs)}

        def sh(a, b):
            return s_hat[(a, b)] if (a, b) in s_hat else s_hat[(b, a)]

        Sn = [sum(sh(d, e) * ndir[e] for e in range(dim)) for d in range(dim)]
        nSn = sum(ndir[d] * Sn[d] for d in range(dim))
        trS = sum(sh(d, d) for d in range(dim))
        radial = torch.where(
            mask, (nmass[:, None, :] + 7.5 * nSn - 1.5 * trS) * u2, 0.0)
        return acc + torch.stack(
            [torch.sum(radial * ndir[d]
                       - torch.where(mask, 3.0 * u2 * Sn[d], 0.0), dim=-1)
             for d in range(dim)], dim=-1)
    fw = torch.where(mask, nmass[:, None, :] * (finv * finv * finv), 0.0)
    return acc + torch.stack([torch.sum(fw * fd, dim=-1) for fd in fdiffs],
                             dim=-1)


def _near_pass(acc, near_ids, nl_chunk, table, bodies, pos_g, S, soft2):
    """Pass 2: the near bag's leafish nodes as contiguous body windows of
    width S, chunk by chunk (``near_ids`` is held in whole chunks), in
    group sub-batches of bounded size."""
    B, G, dim = pos_g.shape
    n_src = bodies.shape[0]
    arangeS = torch.arange(S, dtype=torch.int64, device=pos_g.device)
    sb = max(1, _NEAR_ELEMS // (G * nl_chunk * S))
    for c in range(near_ids.shape[1] // nl_chunk):
        ids_c = near_ids[:, c * nl_chunk:(c + 1) * nl_chunk]
        nvalid = ids_c != _INVALID
        nt = table[torch.where(nvalid, ids_c, 0)]
        l = nt[..., 0].to(torch.int64)
        r = nt[..., 1].to(torch.int64)
        # start < 0 when n_src < S: the clamp below moves only rows that
        # in_rng masks out.
        idx = torch.minimum(l, torch.full_like(l, n_src - S))[..., None] \
            + arangeS
        in_rng = (idx >= l[..., None]) & (idx <= r[..., None]) \
            & nvalid[..., None]
        bt = bodies[idx.clamp(0, n_src - 1)]  # [B, NLc, S, 4]
        spos = bt[..., :dim].reshape(B, -1, dim)
        smass = (bt[..., 3] * in_rng).reshape(B, -1)
        parts = []
        for s0 in range(0, B, sb):
            pg = pos_g[s0:s0 + sb]
            diffs = [spos[s0:s0 + sb, None, :, d] - pg[:, :, None, d]
                     for d in range(dim)]
            d2 = diffs[0] * diffs[0]
            for dd in diffs[1:]:
                d2 = d2 + dd * dd
            inv = torch.rsqrt(d2 + soft2)
            ww = smass[s0:s0 + sb, None, :] * (inv * inv * inv)
            ww = torch.where(d2 < _DIST2_GUARD, 0.0, ww)
            parts.append(torch.stack(
                [torch.sum(ww * dd, dim=-1) for dd in diffs], dim=-1))
        acc = acc + (parts[0] if len(parts) == 1 else torch.cat(parts))
    return acc


def bvh_accel_sorted(tree: BVHTree, leaf_size: int = 16, theta: float = 0.25,
                     softening: float = 0.0, group_size: int = 64,
                     batch: int = 128,
                     frontier_width: Optional[int] = None,
                     near_cap: Optional[int] = None,
                     return_stats: bool = False,
                     multipole: str = "mono",
                     far_impl: str = "point",
                     local_gate: float = 8.0,
                     group_ids: Optional[torch.Tensor] = None,
                     source: Optional[tuple] = None,
                     shard_index: Optional[int] = None,
                     num_shards: int = 1,
                     _debug_skip: str = ""):
    """Accelerations on every sorted body (not G-scaled): [N, D].

    ``group_ids`` ([M] ints) walks only those body groups and returns
    [M·group_size, D] rows in group order (the escalation driver's subset
    re-walk; with ``return_stats`` the stats cover only those groups).
    ``source`` (a ``(node_table, body_table)`` pair) walks another tree of
    the same ``key_bits`` than the one that gives the target groups.
    ``return_stats`` adds (max frontier, max near count, per-group
    overflow). ``far_impl="local"`` sends accepted nodes farther than
    ``local_gate`` group radii into an order-2 local expansion at the group
    centre. With ``num_shards`` > 1 the call walks shard ``shard_index``'s
    groups (module docstring) and returns [N, D] with zero rows outside
    them (``return_stats`` then covers those groups); ``group_ids`` cannot
    be combined with it. ``_debug_skip`` containing ``"far"`` or ``"near"``
    leaves out the inline far field or pass 2 (phase timing).
    """
    if num_shards > 1 and group_ids is not None:
        raise ValueError("group_ids is a single-device escalation path and "
                         "cannot be combined with sharding")
    if num_shards > 1 and (shard_index is None
                           or not 0 <= shard_index < num_shards):
        raise ValueError(f"shard_index must be in [0, {num_shards}) when "
                         f"num_shards > 1, got {shard_index!r}")
    n = tree.n
    dim = tree.pos_sorted.shape[-1]
    dtype = tree.pos_sorted.dtype
    dev = tree.pos_sorted.device
    soft2 = float(softening) ** 2
    qpairs = _quad_pairs(dim)
    table, bodies = (tree.node_table, tree.body_table) \
        if source is None else source
    n_src = bodies.shape[0]
    if multipole == "quad" and table.shape[-1] < 6 + dim + len(qpairs):
        raise ValueError("multipole='quad' needs a tree built with "
                         "build_bvh(..., quad=True)")
    if frontier_width is None:
        frontier_width = min(1024 if dim == 2 else 8192, 2 * n)
    if near_cap is None:
        near_cap = min(1024 if dim == 2 else 8192, 2 * n)
    W, NL = frontier_width, near_cap
    S = leaf_size
    # Capacities rounded up to whole chunks: torch slicing truncates a
    # ragged last chunk (a dynamic_slice would clamp and read twice).
    nl_chunk = min(NL, max(1, 2048 // S))
    NL = -(-NL // nl_chunk) * nl_chunk
    # Depth bound: key bits + index-tiebreak bits (duplicate keys).
    max_depth = tree.key_bits + max(
        1, math.ceil(math.log2(max(n_src, 2)))) + 2

    G = group_size
    ngroups = -(-n // G)
    pad = ngroups * G - n
    # Pad with copies of the last body: keeps the last group's sphere tight.
    pos_pad = torch.cat([tree.pos_sorted,
                         tree.pos_sorted[-1:].expand(pad, dim)]) \
        if pad else tree.pos_sorted
    gpos = pos_pad.reshape(ngroups, G, dim)
    gmin = gpos.amin(dim=1)
    gmax = gpos.amax(dim=1)
    gcenter = 0.5 * (gmin + gmax)
    gext = gmax - gmin
    gradius = 0.5 * torch.sqrt(torch.sum(gext * gext, dim=-1))

    root = 0 if n_src > 1 else n_src - 1
    Wc = min(W, 256)  # frontier chunk
    W = -(-W // Wc) * Wc
    use_local = far_impl == "local"
    if use_local:
        from .local_expansion import eval_local, local_coeffs, num_coeffs
        _, njc, nhc = num_coeffs(dim)

    def held(ids, cols):
        """The first ``cols`` columns of sorted ids, padded with _INVALID."""
        if ids.shape[1] >= cols:
            return ids[:, :cols]
        return torch.cat([ids, ids.new_full((ids.shape[0], cols
                                             - ids.shape[1]), _INVALID)], 1)

    def one_batch(pos_g, center_g, radius_g):
        B = pos_g.shape[0]
        # The frontier [B, W] and the near bag [B, NL] are held only as wide
        # as the batch's largest count, rounded up to whole chunks: the
        # columns past it are all _INVALID and no chunk reads them.
        f = torch.full((B, Wc), _INVALID, dtype=torch.int64, device=dev)
        f[:, 0] = root
        acc = torch.zeros_like(pos_g)
        near_ids = torch.full((B, 0), _INVALID, dtype=torch.int64,
                              device=dev)
        near_cnt = torch.zeros((B,), dtype=torch.int64, device=dev)
        overflow = torch.zeros((B,), dtype=torch.bool, device=dev)
        maxw = torch.zeros((B,), dtype=torch.int64, device=dev)
        if use_local:
            la0 = torch.zeros((B, dim), dtype=dtype, device=dev)
            lJ = torch.zeros((B, njc), dtype=dtype, device=dev)
            lH = torch.zeros((B, nhc), dtype=dtype, device=dev)
        # Frontier and near bag are sort-compacted: row r's entries fill
        # its first columns, so chunk c holds work iff the batch's largest
        # count exceeds c·Wc (the JAX package's cond skips exactly those).
        width, near_max, it = 1, 0, 0
        with span("bvh.frontier", dev):
            while it < max_depth and width > 0:
                kids, leaves = [], []
                for c in range(-(-width // Wc)):
                    fch = f[:, c * Wc:(c + 1) * Wc]
                    valid = fch != _INVALID
                    nt = table[torch.where(valid, fch, 0)]  # one row gather
                    l, r = nt[..., 0], nt[..., 1]
                    nmass = nt[..., 5]
                    com = nt[..., 6:6 + dim]
                    leafish = (r - l + 1 <= S) & valid
                    cdiff = com - center_g[:, None, :]
                    cdist = torch.sqrt(torch.sum(cdiff * cdiff, dim=-1))
                    # Group MAC, shrunk by the group radius so it holds for
                    # every member; MAC-passing leafish nodes go far too.
                    mac_ok = (nt[..., 4]
                              < theta * (cdist - radius_g[:, None])) & valid
                    near_take = leafish & ~mac_ok
                    expand = valid & ~leafish & ~mac_ok
                    if use_local:
                        far_loc = mac_ok & (cdist
                                            > local_gate * radius_g[:, None])
                        mac_inline = mac_ok & ~far_loc
                    else:
                        mac_inline = mac_ok
                    if "far" not in _debug_skip:
                        acc = _far_inline(acc, nt, nmass, com, pos_g,
                                          mac_inline[:, None, :], soft2,
                                          multipole, qpairs)
                    kids.append(torch.where(expand, nt[..., 2].to(torch.int64),
                                            _INVALID))
                    kids.append(torch.where(expand, nt[..., 3].to(torch.int64),
                                            _INVALID))
                    leaves.append(torch.where(near_take, fch, _INVALID))
                    if use_local:
                        Sl = (nt[..., 6 + dim:6 + dim + len(qpairs)]
                              * far_loc[..., None] if multipole == "quad"
                              else None)
                        da0, dJ, dH = local_coeffs(center_g, com,
                                                   nmass * far_loc, Sl,
                                                   softening=softening)
                        la0, lJ, lH = la0 + da0, lJ + dJ, lH + dH
                # Compaction by sort: _INVALID sorts to the end. The unwritten
                # chunks of the JAX package's buffers are all _INVALID.
                kids_buf = torch.cat(kids, dim=1)
                nkids = (kids_buf != _INVALID).sum(dim=1)
                overflow = overflow | (nkids > W)
                maxw = torch.maximum(maxw, nkids)
                leaf_buf = torch.cat(leaves, dim=1)
                near_cnt = near_cnt + (leaf_buf != _INVALID).sum(dim=1)
                overflow = overflow | (near_cnt > NL)
                width, near_max = _read(torch.stack([nkids.amax(),
                                                     near_cnt.amax()]))
                width = min(width, W)
                f = held(torch.sort(kids_buf, dim=1).values,
                         max(1, -(-width // Wc)) * Wc)
                near_ids = held(torch.sort(torch.cat([near_ids, leaf_buf], 1),
                                           dim=1).values,
                                -(-min(near_max, NL) // nl_chunk) * nl_chunk)
                it += 1
            if use_local:
                acc = acc + eval_local(pos_g - center_g[:, None, :], la0,
                                       lJ, lH)
        count("bvh.walk_iters", it)
        # A walk past max_depth must poison, not drop its subtrees.
        overflow = overflow | (f != _INVALID).any(dim=1)

        if "near" not in _debug_skip:
            with span("bvh.near", dev):
                acc = _near_pass(acc, near_ids, nl_chunk, table, bodies,
                                 pos_g, S, soft2)
        # Overflow is never truncated silently: poison the group.
        acc = torch.where(overflow[:, None, None], float("nan"), acc)
        return acc, maxw, near_cnt, overflow

    g0 = 0
    if group_ids is not None:
        gids = torch.as_tensor(group_ids, device=dev).to(torch.int64)\
            .clamp(0, ngroups - 1)
        gpos, gcenter, gradius = gpos[gids], gcenter[gids], gradius[gids]
        my_groups = gids.shape[0]
    elif num_shards > 1:
        gp = -(-ngroups // num_shards)
        g0, g1 = min(shard_index * gp, ngroups), min((shard_index + 1) * gp,
                                                     ngroups)
        gpos, gcenter, gradius = gpos[g0:g1], gcenter[g0:g1], gradius[g0:g1]
        my_groups = g1 - g0
        if my_groups == 0:
            acc = pos_pad.new_zeros((n, dim))
            if not return_stats:
                return acc
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            return acc, zero, zero, torch.zeros((0,), dtype=torch.bool,
                                                device=dev)
    else:
        my_groups = ngroups

    batch = min(batch, my_groups)
    nb = -(-my_groups // batch)
    bpad = nb * batch - my_groups

    def pad0(x):
        return torch.cat([x, x.new_zeros((bpad,) + x.shape[1:])]) \
            if bpad else x

    gpos, gcenter, gradius = pad0(gpos), pad0(gcenter), pad0(gradius)
    outs = [one_batch(gpos[b0:b0 + batch], gcenter[b0:b0 + batch],
                      gradius[b0:b0 + batch])
            for b0 in range(0, nb * batch, batch)]
    acc = torch.cat([o[0] for o in outs]).reshape(-1, dim)[:my_groups * G]
    if num_shards > 1:
        b0 = g0 * G
        b1 = min(b0 + my_groups * G, n)
        full = acc.new_zeros((n, dim))
        full[b0:b1] = acc[:b1 - b0]
        acc = full
    elif group_ids is None:
        acc = acc[:n]
    if not return_stats:
        return acc
    # Padding groups never overflow; keep them out of the stats anyway.
    maxw = torch.cat([o[1] for o in outs])[:my_groups]
    ncnt = torch.cat([o[2] for o in outs])[:my_groups]
    g_over = torch.cat([o[3] for o in outs])[:my_groups]
    return acc, maxw.amax(), ncnt.amax(), g_over


def _bvh_eval(positions, masses, g, *, key_bits, quad, leaf_size, theta,
              softening, group_size, batch, frontier_width, near_cap,
              multipole, far_impl="point", local_gate=8.0):
    """Build, walk with stats, unsort and G-scale: (forces, max frontier,
    max near count, per-group overflow, tree). The tree comes back so the
    escalation re-walk needs no second build."""
    with span("bvh.build", positions.device):
        tree = build_bvh(positions, masses, key_bits, quad=quad)
    acc_sorted, maxw, ncnt, g_over = bvh_accel_sorted(
        tree, leaf_size=leaf_size, theta=theta, softening=softening,
        group_size=group_size, batch=batch, frontier_width=frontier_width,
        near_cap=near_cap, return_stats=True, multipole=multipole,
        far_impl=far_impl, local_gate=local_gate)
    acc = torch.empty_like(acc_sorted)
    acc[tree.order] = acc_sorted  # order is a permutation: exact
    return (g * masses)[:, None] * acc, maxw, ncnt, g_over, tree


def _cap_bucket(x: int) -> int:
    """Round up to a 1/8-power-of-two grid (at least 2048 wide), so
    settled escalation caps repeat from step to step."""
    if x <= 0:
        return 0
    g = max(2048, 1 << max(x.bit_length() - 4, 0))
    return -(-x // g) * g


def resolve_bvh_far_impl(n: int) -> str:
    """The JAX package's far_impl default: the gated order-2 local
    expansion ("local") from N = 5e6, per-body evaluation ("point") below.
    Shared by :func:`bvh_forces` and the registry's hyper record."""
    return "local" if n >= 5_000_000 else "point"


def bvh_forces(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    leaf_size: int = 16,
    theta: Optional[float] = None,
    group_size: Optional[int] = None,
    batch: int = 128,
    frontier_width: Optional[int] = None,
    near_cap: Optional[int] = None,
    max_escalations: int = 3,
    multipole: str = "quad",
    far_impl: Optional[str] = None,
    local_gate: float = 8.0,
    caps_state: Optional[dict] = None,
) -> torch.Tensor:
    """Per-body forces via the Hilbert radix BVH (the reference's
    ``bvh_*_n_body``, ``max_bodies_per_leaf = 16``), on the bodies' device.

    ``multipole="quad"`` (default) adds the COM-centred quadrupole to
    MAC-accepted nodes (``"mono"`` is the reference's monopole). The walk's
    frontier and near capacities default to sizes that fit uniform inputs
    (1024 in 2D, 8192 in 3D, at most 2N); a clustered input that exceeds
    them poisons its groups with NaN, and this driver re-walks only those
    groups at raised capacities (doubled past the high-water counts, at
    most ``max_escalations`` times, bounded by 2N, the subset padded to a
    power of two). ``caps_state``: a dict, empty at first, that stepping
    loops pass on every call; it keeps the settled capacities (1.2× the
    high-water counts on :func:`_cap_bucket`'s grid) and seeds the next
    call's first re-walk.
    """
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    if far_impl is None:
        far_impl = resolve_bvh_far_impl(n)
    if group_size is None:
        group_size = 1024
    key_bits = dim * MAX_BITS[dim]
    g = float(config.G)
    G = min(group_size, max(1, n))
    w = frontier_width if frontier_width is not None \
        else min(1024 if dim == 2 else 8192, 2 * n)
    nl = near_cap if near_cap is not None \
        else min(1024 if dim == 2 else 8192, 2 * n)

    def chunked(width):
        wc = min(width, 256)
        return -(-width // wc) * wc  # the walk's chunk-rounded capacity

    def nl_chunked(cap):
        c = min(cap, max(1, 2048 // leaf_size))
        return -(-cap // c) * c  # the walk's near cap, in pass-2 chunks

    walk = dict(leaf_size=leaf_size, theta=float(theta),
                softening=float(config.softening), group_size=G, batch=batch,
                multipole=multipole, far_impl=far_impl, local_gate=local_gate)
    forces, maxw, ncnt, g_over, tree = _bvh_eval(
        positions, masses, g, key_bits=key_bits, quad=(multipole == "quad"),
        frontier_width=w, near_cap=nl, **walk)
    need_w, need_nl = _read(torch.stack([maxw, ncnt]))
    if (need_w <= chunked(w) and need_nl <= nl_chunked(nl)) \
            or max_escalations == 0:
        return forces

    # Re-walk only the overflowed (NaN-poisoned) groups, padded to a power
    # of two with copies of a real group.
    ids = np.nonzero(np.asarray(_read(g_over)))[0]
    if ids.size == 0:  # stats over the caps but no group flagged:
        return forces  # nothing was poisoned.
    M = 1 << max(0, int(ids.size - 1).bit_length())
    ids_p = np.concatenate([ids, np.full(M - ids.size, ids[0], ids.dtype)])
    w2, nl2 = w, nl
    if caps_state:
        w2 = min(2 * n, max(w2, int(caps_state.get("w2", 0))))
        nl2 = min(2 * n, max(nl2, int(caps_state.get("nl2", 0))))
    gids = torch.as_tensor(ids_p, dtype=torch.int64, device=positions.device)
    for _ in range(max_escalations):
        # Counts under overflow are lower bounds (a truncated frontier
        # expands less), so double past them.
        if need_w > chunked(w2):
            w2 = min(2 * n, max(2 * chunked(w2), 2 * need_w))
        if need_nl > nl_chunked(nl2):
            nl2 = min(2 * n, max(2 * nl2, 2 * need_nl))
        with span("bvh.rewalk", positions.device):
            sub_acc, maxw2, ncnt2, _ = bvh_accel_sorted(
                tree, frontier_width=w2, near_cap=nl2, return_stats=True,
                group_ids=gids, **walk)
            need_w, need_nl = _read(torch.stack([maxw2, ncnt2]))
        count("bvh.escalations")
        count("bvh.rewalk_groups", M)
        if (need_w <= chunked(w2) and need_nl <= nl_chunked(nl2)) \
                or (chunked(w2) >= 2 * n and nl2 >= 2 * n):
            break
    if caps_state is not None:
        caps_state["w2"] = _cap_bucket(int(1.2 * need_w) + 1)
        caps_state["nl2"] = _cap_bucket(int(1.2 * need_nl) + 1)
    rows = (ids_p[:, None] * G + np.arange(G)).reshape(-1)
    valid = rows < n
    rows_v = torch.as_tensor(rows[valid], device=positions.device)
    sub_rows = sub_acc[torch.as_tensor(valid, device=positions.device)]
    sub_forces = (g * tree.mass_sorted[rows_v])[:, None] * sub_rows
    # The padded subset repeats a real group, so some rows are written
    # twice with identical values: index_put_'s undefined write order on
    # CUDA cannot change the result.
    forces[tree.order[rows_v]] = sub_forces
    return forces
