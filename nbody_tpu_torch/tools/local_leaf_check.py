"""The grid Barnes-Hut tier's far fields against the blocked oracle.

Port of the repo's ``tools/local_leaf_check.py``. For ``far_impl`` point,
local, local_leaf and hier, ``barnes_hut_grid``'s scale-normalized error and
reference-metric accuracy (% of bodies within 1%) against
``brute_force_blocked`` on the same bodies, and with ``--time`` the least
of ``--reps`` CUDA-event times. The JAX tool's ``--cpu`` is ``--device cpu``
here (accuracy only, as there).

Bodies: the reference distribution from ``torch.Generator().manual_seed(0)``.

    python -m nbody_tpu_torch.tools.local_leaf_check [-N 20000] [--dim 3]
        [--theta 0.25] [--device cpu] [--time] [--reps 3] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.brute_force import brute_force_blocked
from ..ops.grid_tree import barnes_hut_grid
from ..state import random_system
from ..utils.accuracy import accuracy_percentage, scale_normalized_error
from .common import RESULTS_DIR, card_line, device_or_none, time_once, \
    write_record

SEED = 0
FAR_IMPLS = ("point", "local", "local_leaf", "hier")


def far_impl_rows(pos, mass, cfg, theta: float, reps: int = 0) -> list:
    """One row a far field: its error and accuracy against the blocked
    oracle and, with ``reps`` > 0, the least of ``reps`` times (ms)."""
    ref = brute_force_blocked(pos, mass, cfg)
    rows = []
    for impl in FAR_IMPLS:
        def run(impl=impl):
            return barnes_hut_grid(pos, mass, cfg, theta=theta,
                                   far_impl=impl)
        f = run()
        row = {"far_impl": impl,
               "err": float(scale_normalized_error(f, ref)),
               "acc": float(accuracy_percentage(f, ref))}
        if reps:
            row["ms"] = min(time_once(run, pos.device)[1]
                            for _ in range(reps))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.local_leaf_check")
    ap.add_argument("-N", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "local_leaf_check.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "local_leaf_check")
    if dev is None:
        return 2

    cfg = GravityConfig()
    s = random_system(args.N, args.dim,
                      generator=torch.Generator().manual_seed(SEED),
                      device=dev)
    smi = card_line(dev)
    print(f"device={smi} N={args.N} dim={args.dim} theta={args.theta}")
    rows = far_impl_rows(s.positions, s.masses, cfg, args.theta,
                         args.reps if args.time else 0)
    for row in rows:
        line = (f"  far_impl={row['far_impl']:<11} err={row['err']:.3e} "
                f"acc={row['acc']:.2f}%")
        if "ms" in row:
            line += f"  t={row['ms'] / 1e3:.3f}s (min of {args.reps})"
        print(line, flush=True)
    write_record(args.out, {"device": smi, "n": args.N, "dim": args.dim,
                            "theta": args.theta, "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
