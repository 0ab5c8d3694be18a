"""Demo: the ring brute force over a mesh of every visible card.

Port of the repo's ``examples/multichip_ring.py``: one ring evaluation of
N = 8192 3D bodies over ``make_mesh()`` (every visible CUDA device), or
over P virtual shards of ``cuda:0`` (``--virtual P``), or a CPU mesh of P
shards (``--cpu P``), timed after a warm-up.

    python -m nbody_tpu_torch.examples.multichip_ring [--virtual 4] [--cpu 4]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..config import GravityConfig
from ..parallel import make_mesh, ring_brute_force
from ..state import random_system
from ..tools.common import card_line, device_or_none, sync


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = p.add_mutually_exclusive_group()
    g.add_argument("--virtual", type=int, metavar="P",
                   help="P virtual shards of cuda:0")
    g.add_argument("--cpu", type=int, metavar="P", help="a CPU mesh of P")
    p.add_argument("--n", type=int, default=8192)
    args = p.parse_args(argv)
    dev = device_or_none("cpu" if args.cpu else "cuda", "multichip_ring")
    if dev is None:
        return 2
    if args.cpu:
        mesh = make_mesh([dev] * args.cpu)
    elif args.virtual:
        mesh = make_mesh([torch.device("cuda", 0)] * args.virtual)
    else:
        mesh = make_mesh()
    home = mesh.devices[0]
    print(f"{mesh.num_shards} shard(s) on "
          f"{[str(d) for d in mesh.distinct_devices]}: {card_line(home)}")

    system = random_system(args.n, 3, generator=torch.Generator().manual_seed(
        0), device=home)
    cfg = GravityConfig()
    ring_brute_force(system.positions, system.masses, cfg, mesh=mesh)
    sync(home)
    t0 = time.perf_counter()
    forces = ring_brute_force(system.positions, system.masses, cfg,
                              mesh=mesh)
    checksum = float(forces.abs().sum())
    dt = time.perf_counter() - t0
    print(f"ring forces over {mesh.num_shards} shards: {dt * 1e3:.1f} ms "
          f"(checksum {checksum:.3e}), on {forces.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
