"""Grid Barnes-Hut leaf level × leaf batch sweep (θ = 0.25, k = 3).

Port of the repo's ``tools/bh_tune.py``. Times ``barnes_hut_grid`` at leaf
levels auto−1 to auto+2 (or ``--levels``) × ``--batches``, each with its
capacity computed for that level: one call timed with CUDA events after a
warm-up call. A point that runs out of the card's memory is recorded as
that row's outcome (``common.ROW_FAILURES``); any other error propagates.

Bodies: the reference distribution from ``torch.Generator().manual_seed(7)``.

    python -m nbody_tpu_torch.tools.bh_tune [--n 100000] [--dim 2]
        [--theta 0.25] [--levels 4,5] [--batches 256,512,1024]
        [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.grid_tree import (auto_leaf_level, barnes_hut_grid,
                             compute_capacity, theta_to_ring)
from ..state import random_system
from ..utils.cuda_build import LAUNCHES
from .common import (RESULTS_DIR, ROW_FAILURES, card_line, device_or_none,
                     row_failure, time_once, write_record)

SEED = 7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.bh_tune")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--levels", default=None,
                    help="comma list; default auto-1..auto+2")
    ap.add_argument("--batches", default="256,512,1024")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "bh_tune.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "bh_tune")
    if dev is None:
        return 2

    cfg = GravityConfig()
    system = random_system(args.n, args.dim,
                           generator=torch.Generator().manual_seed(SEED),
                           device=dev)
    k = theta_to_ring(args.theta)
    auto = auto_leaf_level(args.n, args.dim, k=k)
    levels = ([int(x) for x in args.levels.split(",")] if args.levels
              else [max(1, auto - 1), auto, auto + 1, auto + 2])
    batches = [int(x) for x in args.batches.split(",")]
    smi = card_line(dev)
    print(f"N={args.n} {args.dim}D theta={args.theta} (k={k}) auto_level="
          f"{auto} on {smi}", flush=True)
    rows = []
    for lvl in levels:
        cap = compute_capacity(system.positions, lvl)
        ncells = 1 << (args.dim * lvl)
        for b in batches:
            row = {"level": lvl, "cells": ncells, "capacity": cap,
                   "batch": b}

            def run(lvl=lvl, cap=cap, b=b):
                return barnes_hut_grid(system.positions, system.masses, cfg,
                                       theta=args.theta, leaf_level=lvl,
                                       capacity=cap, leaf_batch=b)
            try:
                run()  # warm-up
                before = LAUNCHES["near_field"]
                _, ms = time_once(run, dev)
                row.update(time_s=ms / 1e3,
                           k6_launches=LAUNCHES["near_field"] - before)
                print(f"  L={lvl} (cells={ncells}, cap={cap}, occ="
                      f"{args.n / ncells:.1f}) batch={b}: {ms / 1e3:.3f} s",
                      flush=True)
            except ROW_FAILURES as e:
                row["error"] = row_failure(e)
                print(f"  L={lvl} batch={b}: FAILED {row['error']}",
                      flush=True)
            rows.append(row)
    write_record(args.out, {"device": smi, "n": args.n, "dim": args.dim,
                            "theta": args.theta, "auto_level": auto,
                            "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
