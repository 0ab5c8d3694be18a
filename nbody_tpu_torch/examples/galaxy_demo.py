"""Demo: evolve a rotating disk galaxy and plot it before and after.

Port of the repo's ``examples/galaxy_demo.py``: ``models.spiral_galaxy``
(G = 1) stepped through ``Simulation`` with the chosen force method,
printing the energy's drift.

    python -m nbody_tpu_torch.examples.galaxy_demo [--n 20000] [--steps 200]
        [--method fmm] [--device cpu]

Writes ``results/torch/galaxy_demo.png`` (before/after panels) where
matplotlib is installed.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..models import spiral_galaxy
from ..simulation import Simulation, available_methods
from ..tools.common import RESULTS_DIR, card_line, device_or_none


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--dt", type=float, default=2e-3)
    p.add_argument("--method", default="fmm", choices=available_methods())
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                 "galaxy_demo.png"))
    args = p.parse_args(argv)
    dev = device_or_none(args.device, "galaxy_demo")
    if dev is None:
        return 2

    system, cfg = spiral_galaxy(
        args.n, generator=torch.Generator().manual_seed(args.seed),
        device=dev)
    sim = Simulation.create(system, cfg, method=args.method)
    e0 = sim.energy()
    print(f"N={args.n} method={args.method} device={card_line(dev)}")
    print(f"E0 = {e0['total']:.6f} (K {e0['kinetic']:.4f} / "
          f"U {e0['potential']:.4f})")

    before = sim.system.positions.cpu().numpy()
    sim = sim.run(steps=args.steps, dt=args.dt)
    after = sim.system.positions.cpu().numpy()
    e1 = sim.energy()
    drift = (e1["total"] - e0["total"]) / abs(e0["total"])
    print(f"E after {args.steps} steps = {e1['total']:.6f} "
          f"(drift {drift:.2e})")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return 0

    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    for ax, pts, title in ((axes[0], before, "t = 0"),
                           (axes[1], after, f"t = {args.steps * args.dt:g}")):
        ax.scatter(pts[1:, 0], pts[1:, 1], s=0.3, alpha=0.4, lw=0)
        ax.scatter([pts[0, 0]], [pts[0, 1]], s=30, c="red")
        ax.set_xlim(-6, 6)
        ax.set_ylim(-6, 6)
        ax.set_aspect("equal")
        ax.set_title(title)
    fig.suptitle(f"spiral galaxy, {args.method} forces, N={args.n}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
