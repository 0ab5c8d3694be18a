"""Tree forces over a device mesh: replicated build, sharded evaluation.

Port of ``nbody_tpu.parallel.sharded_tree``. The tree is built once, on the
bodies' device, and copied to each distinct device of the mesh (shards of
one device share it). The evaluation, the O(N · interaction list) part, is
split: Barnes-Hut and the FMM by contiguous Morton leaf ranges (compact
blocks of space), the BVH by contiguous body groups. Each shard's partial
forces are zero outside its own bodies, and :meth:`Mesh.psum` adds them in
shard order. On fp32 CUDA trees the near field of each shard (and segment)
is one launch of the kernel K6 over the shard's leaves (the plain near
field otherwise, as ``p2p_impl="auto"`` resolves it).

Work that the JAX program replicates on every chip (the build, the FMM's
M2M, coarse M2L levels and L2L) runs once per distinct device here, not
once per shard: on a mesh of virtual shards of one card the numbers are
the same, without P copies of the work.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..ops.bvh import build_bvh, bvh_accel_sorted
from ..ops.fmm import fmm_shard_partials
from ..ops.grid_tree import (auto_leaf_level, build_grid_tree,
                             check_grid_capacity, compute_capacity,
                             grid_tree_accel_sorted, theta_to_ring)
from ..ops.keys import MAX_BITS
from .mesh import Mesh, make_mesh


def _leaf_level_for(mesh: Mesh, leaf_level: int, dim: int) -> int:
    """Raise the leaf level until every shard owns a leaf:
    2^(D·L) ≥ num_shards."""
    while (1 << (dim * leaf_level)) < mesh.num_shards:
        leaf_level += 1
    return leaf_level


def _unsort_scale(mesh: Mesh, parts, tree, masses, config: GravityConfig):
    """Add the shards' partials in shard order on the mesh's first device,
    scatter them back through ``tree.order`` on the bodies' device and
    scale by G·m."""
    acc_sorted = mesh.reduce(parts).to(masses.device)
    acc = torch.empty_like(acc_sorted)
    acc[tree.order] = acc_sorted
    return (config.G * masses)[:, None] * acc


def barnes_hut_sharded(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    theta: Optional[float] = None,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    leaf_batch: int = 512,
    multipole: str = "quad",
) -> torch.Tensor:
    """Barnes-Hut forces [N, D], leaf evaluation sharded over the mesh.

    The JAX package's parameters and defaults: θ from ``config``,
    quadrupole far field (``multipole="mono"`` for reference parity)
    evaluated per body, one near-field call a shard.
    """
    mesh = make_mesh() if mesh is None else mesh
    mesh.check(positions, masses)
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    k = theta_to_ring(theta)
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim, k=k)
    leaf_level = _leaf_level_for(mesh, leaf_level, dim)
    if capacity is None:
        capacity = compute_capacity(positions, leaf_level)
        check_grid_capacity(capacity, n, leaf_level, dim,
                            "barnes_hut_sharded")

    tree = build_grid_tree(positions, masses, leaf_level, capacity,
                           quad=(multipole == "quad"))
    trees = mesh.replicate(tree)
    parts = mesh.per_shard(lambda r: grid_tree_accel_sorted(
        trees[r], k=k, softening=float(config.softening),
        leaf_batch=leaf_batch, multipole=multipole, shard_index=r,
        num_shards=mesh.num_shards))
    return _unsort_scale(mesh, parts, tree, masses, config)


def fmm_sharded(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    order: int = 5,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    leaf_batch: int = 1024,
) -> torch.Tensor:
    """FMM forces [N, D]: P2M, M2L and L2P + P2P sharded over the mesh
    (``ops/fmm.fmm_shard_partials``): per-shard leaf chunks and M2L cell
    rows, gathered level arrays, added partials. Dense layout only, as in
    the JAX package."""
    mesh = make_mesh() if mesh is None else mesh
    mesh.check(positions, masses)
    n, dim = positions.shape
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim)
    leaf_level = _leaf_level_for(mesh, leaf_level, dim)
    if capacity is None:
        capacity = compute_capacity(positions, leaf_level)
        check_grid_capacity(capacity, n, leaf_level, dim, "fmm_sharded")

    tree = build_grid_tree(positions, masses, leaf_level, capacity)
    parts = fmm_shard_partials(
        mesh.replicate(tree), mesh, order=order,
        softening=float(config.softening), leaf_batch=leaf_batch,
        p2p_impl="auto")
    return _unsort_scale(mesh, parts, tree, masses, config)


def bvh_sharded(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    leaf_size: int = 16,
    theta: Optional[float] = None,
    group_size: Optional[int] = None,
    multipole: str = "quad",
) -> torch.Tensor:
    """BVH forces [N, D]: group walks sharded over the mesh (replicated
    radix tree, per-shard group slices, added partials). No subset
    escalation: a group over the walk's capacities is NaN, as in the JAX
    package's sharded path."""
    mesh = make_mesh() if mesh is None else mesh
    mesh.check(positions, masses)
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    if group_size is None:
        group_size = 1024  # bvh_forces' default
    group_size = min(group_size, max(1, n))

    tree = build_bvh(positions, masses, dim * MAX_BITS[dim],
                     quad=(multipole == "quad"))
    trees = mesh.replicate(tree)
    parts = mesh.per_shard(lambda r: bvh_accel_sorted(
        trees[r], leaf_size=leaf_size, theta=float(theta),
        softening=float(config.softening), group_size=group_size,
        multipole=multipole, shard_index=r, num_shards=mesh.num_shards))
    return _unsort_scale(mesh, parts, tree, masses, config)
