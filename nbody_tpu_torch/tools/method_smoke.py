"""Accuracy smoke on the card: every registered method against the oracle.

Port of the repo's ``tools/tpu_smoke.py``, the check to run after any
kernel or numerics change. The CPU tests run each kernel's plain version;
this runs every method of ``bench/registry.methods_for_tiers`` on the
chosen device, kernels included, and gates its scale-normalized error
against the blocked plain oracle (``brute_force_blocked``, block 1024)
on the same bodies.

    python -m nbody_tpu_torch.tools.method_smoke [-N 20000] [--dim 2]
        [--clustered] [--local-far] [--device cpu]

Exit 1 if any method errs or exceeds its budget.

The budgets are the JAX tool's (``BUDGETS``, ``CLUSTERED_BUDGETS``), set
there at ~3× the errors read on a TPU v5e at N = 20,000 on its draw; they
are kept as the gate but for one row set by the same rule on this tool's
draw (θ = 0.5 in 2D, at ``BUDGETS``), and the card's own readings stand in
``PERF.md``. The JAX tool picks a budget by name prefix, most specific
first; the port's names would miss that way (``BruteForce_Torch``, the
oracle's own blocking, would take the 5e-5 ``BruteForce`` row, where its
twin ``BruteForce_JNP`` has 1e-7), so each port name maps to its row
explicitly (``BUDGET_ROW``), and a name without a row raises.

Bodies: the reference distribution (``random_system``) from
``torch.Generator().manual_seed(42)``, or with ``--clustered`` 60% of them
in a core 1e-4 of the domain wide (the sparse grid's and the BVH
escalation's input). The generator is not ``jax.random``: the bodies are
the same distribution as the JAX tool's, not the same draws.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Tuple

import torch

from ..config import DEFAULT_TREE, GravityConfig
from ..state import System, random_system
from .common import card_line, device_or_none

SEED = 42

# Per-(row, dim) error budgets of the JAX tool (scale-normalized, fp32
# against the fp32 oracle): ~3x its v5e readings at N = 20,000 on its
# jax.random draw. One row differs, by the same rule on this tool's draw:
# θ = 0.5 in 2D reads 2.080e-4 on these bodies in the JAX package itself
# (and in the port), where it read 2.04e-5 on the JAX tool's (one body at
# the edge of an accepted cell sets the max), so the budget is 3x that
# reading, 7e-4 for the JAX tool's 7e-5; tests/test_torch_tools.py takes
# the JAX package's reading on these bodies.
BUDGETS = {
    "BruteForce_JNP": {2: 1e-7, 3: 1e-7},  # a blocking of the oracle
    "BruteForce": {2: 5e-5, 3: 7e-5},
    "BarnesHut_Grid_Theta05": {2: 7e-4, 3: 1e-2},
    "BarnesHut": {2: 5e-5, 3: 2.5e-4},
    "BVH": {2: 5e-5, 3: 1e-4},
    "FMM": {2: 7e-5, 3: 8e-4},
}

# --clustered (60% of the bodies in a core 1e-4 of the domain wide): the
# JAX tool's, ~3x its CPU-f32 errors.
CLUSTERED_BUDGETS = {
    "BruteForce_JNP": {2: 1e-7, 3: 1e-7},
    "BruteForce": {2: 5e-5, 3: 7e-5},
    "BarnesHut_Grid_Theta05": {2: 2e-3, 3: 2e-2},
    "BarnesHut": {2: 5e-4, 3: 2e-3},
    "BVH": {2: 5e-4, 3: 2e-3},
    "FMM": {2: 5e-4, 3: 2e-3},
}

#: Each registered port method → its row of the budget tables.
BUDGET_ROW = {
    "BruteForce_Torch": "BruteForce_JNP",
    "BruteForce_CUDA": "BruteForce",
    "BruteForce_Ring": "BruteForce",
    "BarnesHut_Grid": "BarnesHut",
    "BarnesHut_Grid_Theta05": "BarnesHut_Grid_Theta05",
    "BarnesHut_Sharded": "BarnesHut",
    "BVH_Radix": "BVH",
    "BVH_Sharded": "BVH",
    "FMM_Chebyshev": "FMM",
    "FMM_Sharded": "FMM",
}


def budget_for(name: str, dim: int, clustered: bool = False) -> float:
    """The error budget of the port method ``name`` (a ``+local`` /
    ``+point`` variant takes its tier's)."""
    base = name.split("+")[0]
    if base not in BUDGET_ROW:
        raise KeyError(f"no error budget for {name!r}: add it to BUDGET_ROW")
    table = CLUSTERED_BUDGETS if clustered else BUDGETS
    return table[BUDGET_ROW[base]][dim]


def clustered_system(n: int, dim: int, generator: torch.Generator, device,
                     frac: float = 0.6) -> System:
    """``frac`` of the bodies in a core 1e-4 of the domain wide, the rest
    uniform, in reference units (``random_system``)."""
    base = random_system(n, dim, generator=generator, device=device)
    nc = int(n * frac)
    lo = base.positions.amin(0)
    hi = base.positions.amax(0)
    center, width = 0.5 * (lo + hi), hi - lo
    u = torch.rand((nc, dim), generator=generator).to(device)
    core = center + 1e-4 * width * u
    return base.replace(positions=torch.cat([core, base.positions[nc:]]))


def checks(system: System, cfg: GravityConfig, device, local_far: bool
           ) -> List[Tuple[str, Callable[[], torch.Tensor]]]:
    """(name, forces()) for every registered method on ``device``, and
    with ``local_far`` the non-default far fields of the grid and BVH."""
    from ..bench.registry import methods_for_tiers
    pos, mass = system.positions, system.masses
    out = [(m.name, lambda m=m: m.fn(pos, mass, cfg, DEFAULT_TREE))
           for m in methods_for_tiers("abhf", device)]
    if local_far:
        from ..ops.bvh import bvh_forces
        from ..ops.grid_tree import barnes_hut_grid
        out += [
            ("BarnesHut_Grid+point", lambda: barnes_hut_grid(
                pos, mass, cfg, theta=cfg.theta, far_impl="point")),
            ("BarnesHut_Grid_Theta05+point", lambda: barnes_hut_grid(
                pos, mass, cfg, theta=0.5, far_impl="point")),
            ("BVH_Radix+local", lambda: bvh_forces(pos, mass, cfg,
                                                   far_impl="local")),
        ]
    return out


def run(system: System, device, clustered: bool = False,
        local_far: bool = False, log=print) -> dict:
    """Every check's {name: (error, budget)}; a method that raises is
    recorded as (None, budget) and logged with its error."""
    from ..ops.brute_force import brute_force_blocked
    from ..utils.accuracy import scale_normalized_error
    cfg = GravityConfig()
    oracle = brute_force_blocked(system.positions, system.masses, cfg,
                                 block_size=1024)
    out = {}
    for name, forces in checks(system, cfg, device, local_far):
        b = budget_for(name, system.dim, clustered)
        try:
            err = float(scale_normalized_error(forces(), oracle))
        except Exception as e:  # noqa: BLE001 — an error row, then exit 1
            log(f"  {name:<28} ERROR {type(e).__name__}: {e}")
            out[name] = (None, b)
            continue
        log(f"  {name:<28} err={err:.3e}  budget={b:.0e}  "
            f"{'OK' if err <= b else 'FAIL'}")
        out[name] = (err, b)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-N", type=int, default=20000)
    p.add_argument("--dim", type=int, default=2, choices=(2, 3))
    p.add_argument("--clustered", action="store_true",
                   help="60%%-core clustered input: gates the sparse grid "
                        "and the BVH escalation")
    p.add_argument("--local-far", action="store_true",
                   help="also gate the non-default far fields of the grid "
                        "('point') and the BVH ('local')")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    dev = device_or_none(args.device, "method_smoke")
    if dev is None:
        return 2

    gen = torch.Generator().manual_seed(SEED)
    system = (clustered_system(args.N, args.dim, gen, dev) if args.clustered
              else random_system(args.N, args.dim, generator=gen, device=dev))
    print(f"device={card_line(dev)} N={args.N} dim={args.dim}"
          f"{' clustered' if args.clustered else ''}")
    res = run(system, dev, args.clustered, args.local_far)
    failed = [n for n, (err, b) in res.items() if err is None or err > b]
    if failed:
        print("FAILED:", ", ".join(failed))
        return 1
    print("all methods within budget")
    return 0


if __name__ == "__main__":
    sys.exit(main())
