"""One step and one evaluation of every multi-device tier on a mesh.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: a leapfrog step of the ring brute force at N = 16·P
(3D, fp32), checked finite, then one force evaluation of each tier at
N = 2048 (3D, fp32) against the dense direct sum, with the JAX package's
knobs and gates (scale-normalized error). A tree tier must also read a
nonzero error: zero would mean every interaction went to the near field
and the far field went untested.

    python -m nbody_tpu_torch.parallel.dryrun            # every CUDA device
    python -m nbody_tpu_torch.parallel.dryrun --virtual 4  # 4 shards, cuda:0
    python -m nbody_tpu_torch.parallel.dryrun --cpu 4      # a CPU mesh
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from ..config import GravityConfig
from ..integrators import leapfrog_step
from ..ops.brute_force import brute_force_direct
from ..state import random_system
from ..utils.accuracy import scale_normalized_error
from .let_bvh import let_bvh
from .let_tree import let_barnes_hut, let_fmm
from .mesh import Mesh, make_mesh
from .ring import ring_brute_force
from .sharded_tree import barnes_hut_sharded, bvh_sharded, fmm_sharded

DRYRUN_N = 2048

# (name, forces(pos, mass, cfg, mesh), gate, nonzero error expected): the
# JAX package's knobs and gates (__graft_entry__.py:166-188). The ring is
# exact up to fp32 rounding, so its error may be 0.
TIERS = [
    ("ring brute force (exact)",
     lambda p, m, c, mesh: ring_brute_force(p, m, c, mesh=mesh), 1e-5, False),
    ("sharded FMM",
     lambda p, m, c, mesh: fmm_sharded(p, m, c, mesh=mesh, order=6,
                                       leaf_level=3), 5e-4, True),
    ("sharded BH",
     lambda p, m, c, mesh: barnes_hut_sharded(p, m, c, mesh=mesh, theta=0.5,
                                              leaf_level=3), 1.3e-2, True),
    ("sharded BVH",
     lambda p, m, c, mesh: bvh_sharded(p, m, c, mesh=mesh, theta=0.5,
                                       group_size=8), 3e-3, True),
    ("LET BH (body-sharded)",
     lambda p, m, c, mesh: let_barnes_hut(p, m, c, mesh=mesh, theta=0.5,
                                          leaf_level=3), 1.3e-2, True),
    ("LET FMM (body-sharded)",
     lambda p, m, c, mesh: let_fmm(p, m, c, mesh=mesh, order=6,
                                   leaf_level=3), 5e-4, True),
    ("LET BVH (body-sharded)",
     lambda p, m, c, mesh: let_bvh(p, m, c, mesh=mesh, theta=0.5), 1e-3,
     True),
]


def dryrun_multichip(mesh: Optional[Mesh] = None, seed: int = 0,
                     log=print) -> dict:
    """Run the dry run on ``mesh`` (default: every visible CUDA device);
    raise AssertionError at the first failed check. Returns each tier's
    error."""
    mesh = make_mesh() if mesh is None else mesh
    p = mesh.num_shards
    dev = mesh.devices[0]
    cfg = GravityConfig()
    gen = torch.Generator().manual_seed(seed)

    n = 16 * p
    system = random_system(n, 3, generator=gen, device=dev)
    out = leapfrog_step(system, lambda pos, m: ring_brute_force(
        pos, m, cfg, mesh=mesh), 0.01)
    if out.positions.shape != (n, 3) or not bool(
            torch.isfinite(out.positions).all()):
        raise AssertionError(f"ring leapfrog step at N={n}: shape "
                             f"{tuple(out.positions.shape)} or not finite")
    log(f"dryrun_multichip({p}): ring brute-force leapfrog step OK, N={n}, "
        f"{p} shards on {[str(d) for d in mesh.distinct_devices]}")

    bodies = random_system(max(DRYRUN_N, 2 * n), 3, generator=gen,
                           device=dev)
    want = brute_force_direct(bodies.positions, bodies.masses, cfg)
    errors = {}
    for name, forces, gate, nonzero in TIERS:
        got = forces(bodies.positions, bodies.masses, cfg, mesh)
        err = float(scale_normalized_error(got, want))
        errors[name] = err
        if not err < gate:
            raise AssertionError(f"{name}: scale-normalized error {err:.3e} "
                                 f">= {gate:g} against the direct sum at "
                                 f"N={bodies.n}")
        if nonzero and not err > 0.0:
            raise AssertionError(f"{name}: error exactly 0 at N={bodies.n}: "
                                 f"the far field was never engaged")
        log(f"dryrun_multichip({p}): {name} OK (0 "
            f"{'<' if nonzero else '<='} err {err:.3e} < {gate:g})")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--virtual", type=int, metavar="P",
                   help="P virtual shards on cuda:0")
    g.add_argument("--cpu", type=int, metavar="P", help="a CPU mesh of P")
    args = ap.parse_args(argv)
    if args.cpu:
        mesh = make_mesh([torch.device("cpu")] * args.cpu)
    elif args.virtual:
        mesh = make_mesh([torch.device("cuda", 0)] * args.virtual)
    else:
        mesh = make_mesh()
    dryrun_multichip(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
