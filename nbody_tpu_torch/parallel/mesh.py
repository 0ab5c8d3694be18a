"""A one-dimensional device mesh driven from one process.

Port of ``nbody_tpu.parallel.mesh``. The JAX package runs one program over a
``jax.sharding.Mesh`` with ``shard_map``; here one process holds a list of
per-shard tensors and steps through the shards itself. A :class:`Mesh` is
an ordered list of ``torch.device``s, one per shard, which may repeat:
``[torch.device("cuda", 0)] * 4`` is four virtual shards on one card (as the
JAX tests repeat CPU devices), ``cuda:0..3`` four cards (copies between them
go peer to peer), ``[torch.device("cpu")] * P`` the CPU mesh of the tests.

The :class:`Mesh` type and its collectives (``ppermute``, ``psum`` and
``reduce`` in shard order 0 to P−1, ``pmin``, ``pmax``, ``all_gather``,
``all_to_all``, ``per_device`` for work the JAX program replicates) are
defined in ``utils/device_mesh.py``, below ``ops/``, and re-exported here.
``axis_index`` becomes an explicit ``shard_index`` argument of the sharded
functions.

Nothing here catches a failure or moves work to another kind of device: a
tensor whose device type is not the mesh's raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils.device_mesh import Mesh

__all__ = ["BODY_AXIS", "Mesh", "default_num_shards", "make_mesh",
           "pad_to_multiple", "shard_bodies"]

BODY_AXIS = "x"


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _normalize(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the given devices, or by default over every visible CUDA
    device (``cuda:0`` .. ``cuda:count-1``). Raises without a CUDA device
    when none is given: a CPU mesh is asked for by name."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh(): no CUDA device is visible; pass the devices, "
                "e.g. [torch.device('cpu')] * 4")
        devices = [torch.device("cuda", i) for i in range(count)]
    return Mesh(tuple(_normalize(d) for d in devices))


def default_num_shards() -> int:
    """Shards of the default mesh: the visible CUDA devices."""
    return torch.cuda.device_count()


def shard_bodies(mesh: Mesh, *tensors):
    """Split each tensor's leading (body) axis evenly over the mesh: one
    list of per-shard tensors per input, shard r's on ``devices[r]`` (one
    list alone for one input). The length must divide evenly
    (:func:`pad_to_multiple`)."""
    out = []
    p = mesh.num_shards
    for t in tensors:
        mesh.check(t)
        if t.shape[0] % p:
            raise ValueError(f"{t.shape[0]} rows do not split evenly over "
                             f"{p} shards; pad to a multiple first")
        rows = t.shape[0] // p
        out.append([t[r * rows:(r + 1) * rows].to(d)
                    for r, d in enumerate(mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]
