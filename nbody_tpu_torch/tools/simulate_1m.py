"""Stepping at scale: N = 2^20 leapfrog on a Plummer sphere, energy drift.

Port of the repo's ``tools/simulate_1m.py``: the whole stepping loop (not
only force evaluations) at N = 1,048,576 on the card, with each step's
wall time and the total energy's drift, written to a JSON record.

G = 1 Plummer units (``GravityConfig(G=1.0, softening=0.05)``, a cold
``plummer_system``): in reference units accelerations are ~1e-25 and fp32
positions do not move, so the drift would be zero by construction. The
Plummer sphere is also the clustered case (a dense core), so the default
force method is the Hilbert radix BVH, which carries a ``caps_state``
from step to step: the settled escalation capacities of one evaluation
seed the next. ``--method bh-grid`` runs the uniform grid's Barnes-Hut
(its near field on the K6 kernel) for ``--dist uniform`` inputs; on the
Plummer sphere ``layout="auto"`` sends it to the sparse grid.

Energy: ``kinetic_energy`` and ``potential_energy_blocked(block_size=2048)``,
an O(N²) plain torch sum (as the JAX package's is jnp), timed on its own:
it is not part of a step.

    python -m nbody_tpu_torch.tools.simulate_1m [--n 1048576] [--steps 10] \\
        [--method bvh|bh-grid] [--dist plummer|uniform] [--device cpu]

Writes ``results/torch/simulate_1m_<method>.json`` (the JAX tool's keys,
``backend`` the device type, plus ``device``: the card's name and power
limit, and the times of the seed evaluation and of the energy).
Exits 1 on a non-finite state.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Tuple

import torch

from ..config import GravityConfig
from ..integrators import leapfrog_step_carried
from ..ops.brute_force import kinetic_energy, potential_energy_blocked
from ..state import System, plummer_system
from .common import RESULTS_DIR, card_line, device_or_none, sync

SEED = 3
#: Plummer units: the softening the JAX tool runs with.
CONFIG = GravityConfig(G=1.0, softening=0.05)


def initial_system(n: int, dim: int, dist: str, device,
                   seed: int = SEED) -> System:
    """The Plummer sphere (cold) or the uniform cube [-1, 1]^D of total
    mass 1, drawn from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    if dist == "plummer":
        return plummer_system(n, dim, generator=gen, device=device)
    pos = torch.rand((n, dim), generator=gen) * 2.0 - 1.0
    return System(positions=pos, velocities=torch.zeros_like(pos),
                  masses=torch.full((n,), 1.0 / n)).to(device)


def forces_for(method: str, cfg: GravityConfig, theta: float
               ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The force function of a stepping loop; the BVH's carries its
    ``caps_state`` across calls."""
    if method == "bvh":
        from ..ops.bvh import bvh_forces
        caps: dict = {}
        return lambda p, m: bvh_forces(p, m, cfg, theta=theta,
                                       caps_state=caps)
    if method == "bh-grid":
        from ..ops.grid_tree import barnes_hut_grid
        return lambda p, m: barnes_hut_grid(p, m, cfg, theta=theta)
    raise ValueError(f"method must be 'bvh' or 'bh-grid', got {method!r}")


def energy(s: System, cfg: GravityConfig) -> Tuple[float, float]:
    """(kinetic, potential), the potential by the blocked O(N²) sum."""
    ke = float(kinetic_energy(s.velocities, s.masses))
    pe = float(potential_energy_blocked(s.positions, s.masses, cfg,
                                        block_size=2048))
    return ke, pe


def run(system: System, cfg: GravityConfig, method: str, steps: int,
        dt: float, theta: float, log=print) -> Tuple[System, dict]:
    """``steps`` carried leapfrog steps (one force evaluation each, the
    seed evaluation before them); returns the final state and the record.
    Raises FloatingPointError at a non-finite checksum."""
    dev = system.device
    forces = forces_for(method, cfg, theta)

    def timed_energy(s):
        sync(dev)
        t0 = time.perf_counter()
        ke, pe = energy(s, cfg)
        return ke, pe, time.perf_counter() - t0

    ke0, pe0, pe_s0 = timed_energy(system)
    e0 = ke0 + pe0
    log(f"E0 = {e0:.6e} (KE {ke0:.3e}, PE {pe0:.3e}; energy {pe_s0:.2f} s)")

    sync(dev)
    t0 = time.perf_counter()
    acc = forces(system.positions, system.masses) / system.masses[:, None]
    sync(dev)
    seed_s = time.perf_counter() - t0
    step_times = []
    s = system
    for i in range(steps):
        t0 = time.perf_counter()
        s, acc = leapfrog_step_carried(s, acc, forces, dt)
        checksum = float(s.positions.abs().sum())  # waits for the step
        dt_wall = time.perf_counter() - t0
        step_times.append(dt_wall)
        log(f"step {i + 1:2d}: {dt_wall * 1e3:9.1f} ms  checksum "
            f"{checksum:.6e}")
        if not (0.0 < checksum < float("inf")):
            raise FloatingPointError(f"non-finite state after step {i + 1}")

    ke1, pe1, pe_s1 = timed_energy(s)
    e1 = ke1 + pe1
    drift = abs(e1 - e0) / abs(e0)
    log(f"E{steps} = {e1:.6e} (KE {ke1:.3e}, PE {pe1:.3e}; energy "
        f"{pe_s1:.2f} s)")
    log(f"relative energy drift over {steps} steps: {drift:.3e}")
    later = sorted(step_times[1:])
    record = {
        "n": system.n, "dim": system.dim, "steps": steps, "dt": dt,
        "theta": theta, "integrator": "leapfrog",
        "force_method": ("BVH_Radix(quad)" if method == "bvh"
                         else "BarnesHut_Grid(quad)"),
        "units": "G=1 Plummer",
        "softening": cfg.softening,
        "energy_initial": {"kinetic": ke0, "potential": pe0, "total": e0},
        "energy_final": {"kinetic": ke1, "potential": pe1, "total": e1},
        "relative_energy_drift": drift,
        "seed_eval_s": seed_s,
        "step_wall_s": step_times,
        "step_wall_s_cached_median": later[len(later) // 2] if later
        else None,
        "energy_s": [pe_s0, pe_s1],
    }
    return s, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=3, choices=(2, 3))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--method", default="bvh", choices=("bvh", "bh-grid"))
    ap.add_argument("--dist", default="plummer",
                    choices=("plummer", "uniform"),
                    help="plummer = the clustered case (the BVH's); "
                         "uniform = the cube [-1,1]^D, total mass 1 (the "
                         "grid's)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None,
                    help="default results/torch/simulate_1m_<method>.json")
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "simulate_1m")
    if dev is None:
        return 2

    card = card_line(dev)
    print(f"device={card} N={args.n} dim={args.dim} steps={args.steps} "
          f"dt={args.dt} theta={args.theta} method={args.method} "
          f"dist={args.dist}")
    system = initial_system(args.n, args.dim, args.dist, dev)
    try:
        _, record = run(system, CONFIG, args.method, args.steps, args.dt,
                        args.theta)
    except FloatingPointError as e:
        print(f"{e} — aborting")
        return 1
    record["backend"], record["device"] = dev.type, card
    record["distribution"] = ("plummer_cold (clustered)"
                              if args.dist == "plummer"
                              else "uniform_cube (quasi-uniform)")
    out = args.out or os.path.join(
        RESULTS_DIR, f"simulate_1m_{args.method.replace('-', '_')}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
