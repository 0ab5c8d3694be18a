"""Barnes-Hut at 2e6-5e6 bodies in 3D on the card.

Port of the repo's ``tools/bh_bigN_probe.py``. Times the production
``barnes_hut_grid`` (θ = 0.25: the hierarchical far field, with the 256-leaf
batches from 2e6 and the 4 segments from 4e6 that ``resolve_bh_params``
keeps from the JAX package) at each ``--cases`` size, printing the
resolved parameters, a cold time (the first call) and a warm one (the
second), both CUDA-event times, and the forces' checksum Σ|F|. A size that
runs out of the card's memory is recorded with its error as that row's
outcome (``common.ROW_FAILURES``); any other error propagates.

Bodies: the reference distribution from ``torch.Generator().manual_seed(42)``
(the JAX tool's ``jax.random.key(42)``: other draws). Record:
``results/torch/bh_bigN.json`` by default.

    python -m nbody_tpu_torch.tools.bh_bigN_probe
        [--cases 2000000:3,4000000:3,5000000:3] [--theta 0.25]
        [--far-impl hier] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.grid_tree import barnes_hut_grid, resolve_bh_params
from ..state import random_system
from ..utils.cuda_build import LAUNCHES
from .common import (RESULTS_DIR, ROW_FAILURES, card_line, device_or_none,
                     parse_cases, row_failure, time_once, write_record)

SEED = 42


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.bh_bigN_probe")
    ap.add_argument("--cases", default="2000000:3,4000000:3,5000000:3")
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--far-impl", default=None,
                    help="override far_impl (default: driver resolution)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "bh_bigN.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "bh_bigN_probe")
    if dev is None:
        return 2

    cfg = GravityConfig()
    smi = card_line(dev)
    rows = []
    print(f"device={smi} theta={args.theta}")
    for n, dim in parse_cases(args.cases):
        rp = resolve_bh_params(n, dim, args.theta, far_impl=args.far_impl)
        print(f"N={n} {dim}D params: {rp}", flush=True)
        row = {"n": n, "dim": dim, "theta": args.theta, "hyperparams": rp}
        try:
            system = random_system(
                n, dim, generator=torch.Generator().manual_seed(SEED),
                device=dev)

            def run():
                f = barnes_hut_grid(system.positions, system.masses, cfg,
                                    theta=args.theta, far_impl=args.far_impl)
                return float(f.abs().sum())

            _, cold_ms = time_once(run, dev)
            before = LAUNCHES["near_field"]
            chk, ms = time_once(run, dev)
            row.update(wall_s=ms / 1e3, cold_s=cold_ms / 1e3,
                       finite=0 < chk < math.inf, checksum=chk,
                       k6_launches=LAUNCHES["near_field"] - before)
            print(f"N={n:>8} {dim}D  {ms / 1e3:8.3f} s warm "
                  f"(cold {cold_ms / 1e3:.3f} s)  checksum {chk:.6e}  "
                  f"K6 launches {row['k6_launches']}", flush=True)
        except ROW_FAILURES as e:
            row["error"] = row_failure(e)
            print(f"N={n:>8} {dim}D  FAILED {row['error']}", flush=True)
        rows.append(row)
        system = None

    write_record(args.out, {"device": smi, "rows": rows})
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
