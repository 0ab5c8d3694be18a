"""Multi-device execution: a device mesh, the ring brute force and the
sharded tree tiers, driven from one process (port of
``nbody_tpu.parallel``; its body-sharded LET tiers are not ported yet).

* ``mesh`` — :class:`Mesh`, a list of devices (repeats make virtual shards
  of one card), and the collectives ``ppermute`` / ``psum`` /
  ``all_gather`` on lists of per-shard tensors.
* ``ring`` — exact forces with source blocks rotated around the mesh, on
  the kernels K2 and K3 for fp32 CUDA tensors.
* ``sharded_tree`` — replicated build, sharded evaluation for Barnes-Hut,
  the FMM and the BVH.
* ``dryrun`` — one ring leapfrog step and one evaluation of each tier on a
  mesh, each held to the JAX package's gate.
"""

from .mesh import BODY_AXIS, Mesh, make_mesh, shard_bodies  # noqa: F401
from .ring import ring_all_pairs_segmented, ring_brute_force  # noqa: F401
from .sharded_tree import (  # noqa: F401
    barnes_hut_sharded,
    bvh_sharded,
    fmm_sharded,
)
