"""Multi-device execution: a device mesh, the ring brute force, the
sharded tree tiers and the body-sharded LET tiers, driven from one process
(port of ``nbody_tpu.parallel``).

* ``mesh`` — :class:`Mesh`, a list of devices (repeats make virtual shards
  of one card), and the collectives ``ppermute`` / ``psum`` / ``pmin`` /
  ``pmax`` / ``all_gather`` / ``all_to_all`` on lists of per-shard
  tensors.
* ``ring`` — exact forces with source blocks rotated around the mesh, on
  the kernels K2 and K3 for fp32 CUDA tensors.
* ``sharded_tree`` — replicated build, sharded evaluation for Barnes-Hut,
  the FMM and the BVH.
* ``let_tree``, ``let_bvh`` — bodies sharded by space (O(N/P) a shard),
  exchanged by all_to_all, with locally-essential-tree evaluation:
  Barnes-Hut and the FMM (halo ring), the BVH (per-shard trees on a ring).
* ``dryrun`` — one ring leapfrog step and one evaluation of each tier on a
  mesh, each held to the JAX package's gate.
"""

from .let_bvh import let_bvh  # noqa: F401
from .let_tree import let_barnes_hut, let_fmm  # noqa: F401
from .mesh import BODY_AXIS, Mesh, make_mesh, shard_bodies  # noqa: F401
from .ring import ring_brute_force  # noqa: F401
from .sharded_tree import (  # noqa: F401
    barnes_hut_sharded,
    bvh_sharded,
    fmm_sharded,
)
