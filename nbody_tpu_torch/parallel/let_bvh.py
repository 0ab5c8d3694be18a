"""Body-sharded BVH tier with locally-essential-tree ring evaluation.

Port of ``nbody_tpu.parallel.let_bvh``. Where ``sharded_tree.bvh_sharded``
copies every body and the whole radix tree to each device, here nothing is
replicated:

1. **Exchange**: the grid LET's Morton buckets and all_to_all
   (``let_tree``), at the coarsest level with at least 64 owner cells a
   shard; each shard ends holding the bodies of its spatial chunk. Invalid
   rows (padding, mass 0) are moved onto the last valid body, so they keep
   every AABB tight and add nothing.
2. **Local build**: each shard builds its own radix BVH
   (``ops/bvh.build_bvh``) over its bodies; there is no global tree.
3. **Self pass**: the shard's groups walk their own tree
   (``ops/bvh.bvh_accel_sorted``).
4. **Ring pass**: the packed trees (``node_table``, ``body_table``) rotate
   around the mesh (:meth:`Mesh.rotate`); at each of the P − 1 steps every
   shard's groups walk the foreign tree it holds (``source=``). Distant
   chunks pass the group MAC near the root.

Overflow policy: an exchange-bucket overflow makes every shard's rows NaN;
a frontier or near-list overflow poisons its group, as in the single-device
walk. The capacities are explicit, as in the JAX package: this tier has no
``caps_state`` escalation.

What differs from the JAX package, and why:

* ``shard_map`` and ``lax.scan`` over the ring become Python loops over the
  shards and steps; ``varying_axis`` has no counterpart.
* A shard count that is not a power of two raises ``ValueError``: the JAX
  package's search for the exchange level (a cell count that P divides)
  never ends for such a count.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..ops.bvh import build_bvh, bvh_accel_sorted
from ..ops.keys import MAX_BITS
from .let_tree import (_exchange, _finish, bucket_rows, materialize,
                       shard_padded)
from .mesh import Mesh, make_mesh, pad_to_multiple


def let_bvh(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    theta: Optional[float] = None,
    leaf_size: int = 16,
    group_size: Optional[int] = None,
    batch: int = 128,
    frontier_width: Optional[int] = None,
    near_cap: Optional[int] = None,
    bucket_headroom: Optional[float] = None,
    multipole: str = "quad",
    far_impl: str = "point",
) -> torch.Tensor:
    """BVH forces [N, D] with body-sharded LET distribution: the JAX
    package's parameters and defaults (groups of 1024, quadrupole sources,
    frontier and near capacities 1024 in 2D / 8192 in 3D, at most twice a
    shard's rows). Overflow poisons with NaN (module docstring)."""
    mesh = make_mesh() if mesh is None else mesh
    mesh.check(positions, masses)
    p = mesh.num_shards
    if p & (p - 1):
        raise ValueError(f"let_bvh needs a power-of-two shard count (its "
                         f"exchange grid is split evenly), got {p}")
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    # Exchange level: at least 64 owner cells a shard.
    L = 1
    while (1 << (dim * L)) < 64 * p:
        L += 1
    cc = (1 << (dim * L)) // p
    H = bucket_rows(positions, L, p, pad_to_multiple(n, p * 8),
                    bucket_headroom)
    ph = p * H
    group_size = min(1024 if group_size is None else group_size, ph)
    cap = min(1024 if dim == 2 else 8192, 2 * ph)
    walk = dict(leaf_size=leaf_size, theta=float(theta),
                softening=float(config.softening), group_size=group_size,
                batch=batch, multipole=multipole, far_impl=far_impl,
                frontier_width=cap if frontier_width is None
                else frontier_width,
                near_cap=cap if near_cap is None else near_cap)

    pos, mass, idx = shard_padded(mesh, positions, masses)
    chunks = _exchange(mesh, pos, mass, idx, L=L, cc=cc, H=H, capacity=8)

    def build(r):
        c = chunks[r]
        last = c.pos_sorted.index_select(0, (c.valid.sum() - 1).clamp(
            0, ph - 1).reshape(1))
        pos_b = torch.where(c.valid[:, None], c.pos_sorted, last)
        return build_bvh(pos_b, c.mass_sorted, dim * MAX_BITS[dim],
                         quad=(multipole == "quad"))

    trees = mesh.per_shard(build)
    acc = mesh.per_shard(lambda r: bvh_accel_sorted(trees[r], **walk))
    src = [(t.node_table, t.body_table) for t in trees]
    for _ in range(p - 1):
        src = mesh.rotate(src)
        mesh.per_shard(lambda r: acc[r].add_(bvh_accel_sorted(
            trees[r], source=src[r], **walk)))

    # The walk's rows are in each tree's order: carry the chunk's rows
    # there before the shared finish.
    for c, t in zip(chunks, trees):
        c.mass_sorted, c.idx = c.mass_sorted[t.order], c.idx[t.order]
    forces = _finish(mesh, chunks, acc, [c.overflow for c in chunks],
                     config)
    return materialize(forces, [c.idx for c in chunks], n, positions)
