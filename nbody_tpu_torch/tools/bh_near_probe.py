"""The Barnes-Hut near field alone by leaf level, leaf batch and p2p_impl.

Port of the repo's ``tools/bh_near_probe.py``. Times the near field of the
grid tier alone (``grid_tree_accel_sorted(..., _debug_skip="far")``) on one
tree a leaf level, for each ``--batches`` × ``--impls``: the least of 3
CUDA-event times after a warm-up call. The JAX tool's ``p2p_impl`` names map
to the port's: ``jnp`` → ``plain`` (the default), ``pallas`` → ``cuda``
(K6). Each row after the first of its (level, batch) also gives its
scale-normalized difference from that first row's near forces and the
first row's max/RMS force, from which a caller derives the fp32 floor the
two may differ by. A size that runs out of the card's memory is recorded as
that row's outcome (``common.ROW_FAILURES``); any other error propagates.

Bodies: the reference distribution from ``torch.Generator().manual_seed(7)``.

    python -m nbody_tpu_torch.tools.bh_near_probe [--n 100000] [--dim 3]
        [--theta 0.25] [--levels 4,3] [--batches 512,2048]
        [--impls plain,cuda] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.grid_tree import (auto_leaf_level, build_grid_tree,
                             compute_capacity, grid_tree_accel_sorted,
                             theta_to_ring)
from ..state import random_system
from ..utils.accuracy import scale_normalized_error
from ..utils.cuda_build import LAUNCHES
from .common import (RESULTS_DIR, ROW_FAILURES, card_line, device_or_none,
                     row_failure, time_ms, write_record)

SEED = 7
REPS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.bh_near_probe")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--levels", default=None,
                    help="comma list; default auto,auto-1")
    ap.add_argument("--batches", default="512,2048")
    ap.add_argument("--impls", default="plain")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "bh_near_probe.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "bh_near_probe")
    if dev is None:
        return 2

    cfg = GravityConfig()
    system = random_system(args.n, args.dim,
                           generator=torch.Generator().manual_seed(SEED),
                           device=dev)
    pos, mass = system.positions, system.masses
    k = theta_to_ring(args.theta)
    L_auto = auto_leaf_level(args.n, args.dim, k=k)
    levels = ([int(x) for x in args.levels.split(",")] if args.levels
              else [L_auto, L_auto - 1])
    impls = args.impls.split(",")
    soft = float(cfg.softening)
    smi = card_line(dev)
    print(f"device={smi} N={args.n} dim={args.dim} k={k} L_auto={L_auto}")
    rows = []
    for L in levels:
        cap = compute_capacity(pos, L)
        tree = build_grid_tree(pos, mass, leaf_level=L, capacity=cap,
                               quad=True)
        for lb in (int(x) for x in args.batches.split(",")):
            first = None
            for impl in impls:
                row = {"level": L, "capacity": cap, "batch": lb,
                       "impl": impl}
                line = (f"  L={L} cap={cap:4d} batch={lb:5d} "
                        f"impl={impl:5s} ")
                try:
                    before = LAUNCHES["near_field"]
                    near, ms = time_ms(lambda lb=lb, impl=impl:
                                       grid_tree_accel_sorted(
                                           tree, k=k, softening=soft,
                                           multipole="quad", leaf_batch=lb,
                                           p2p_impl=impl, _debug_skip="far"),
                                       dev, reps=REPS)
                    # A warm-up call and REPS timed ones, each alike.
                    row.update(near_ms=ms, k6_launches=(
                        LAUNCHES["near_field"] - before) // (REPS + 1))
                    line += f"near={ms:8.1f} ms K6 launches " \
                            f"{row['k6_launches']}"
                    if first is None:
                        first = near
                        f = near.double().norm(dim=-1)
                        row["max_over_rms"] = float(
                            f.max() / f.pow(2).mean().sqrt())
                    else:
                        row["err_vs_first"] = float(scale_normalized_error(
                            near.double(), first.double()))
                        line += f" err vs {impls[0]} " \
                                f"{row['err_vs_first']:.3e}"
                except ROW_FAILURES as e:
                    row["error"] = row_failure(e)
                    line += f"FAILED {row['error']}"
                rows.append(row)
                print(line, flush=True)
        del tree
    write_record(args.out, {"device": smi, "n": args.n, "dim": args.dim,
                            "theta": args.theta, "k": k, "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
