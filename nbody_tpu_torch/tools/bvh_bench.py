"""BVH tier timing on the card: far_impl and traversal-knob sweeps.

Port of the repo's ``tools/bvh_bench.py``. Times ``bvh_forces`` (build,
walk, escalation, unsort) for each ``--cases`` (N, dim) at ``--theta`` over
``--impls`` × group size × leaf size × batch × frontier width × near cap
(an empty list keeps the driver's default): one call timed with CUDA
events after a warm-up call (which settles the escalation), with the
checksum Σ|F|. A point that runs out of the card's memory is recorded as
that row's outcome (``common.ROW_FAILURES``); any other error propagates.

Bodies: the reference distribution from ``torch.Generator().manual_seed(7)``.

    python -m nbody_tpu_torch.tools.bvh_bench
        [--cases 100000:2,200000:2,100000:3] [--theta 0.25]
        [--impls point,local] [--group-sizes 128] [--leaf-sizes 16]
        [--batches 128] [--frontier-widths ...] [--near-caps ...]
        [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.bvh import bvh_forces
from ..state import random_system
from .common import (RESULTS_DIR, ROW_FAILURES, card_line, device_or_none,
                     parse_cases, row_failure, time_ms, write_record)

SEED = 7


def _ints(spec: str, default):
    return [int(x) for x in spec.split(",")] if spec else [default]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.bvh_bench")
    ap.add_argument("--cases", default="100000:2,200000:2,100000:3")
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--impls", default="point,local")
    ap.add_argument("--group-sizes", default="")
    ap.add_argument("--leaf-sizes", default="")
    ap.add_argument("--batches", default="")
    ap.add_argument("--frontier-widths", default="")
    ap.add_argument("--near-caps", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "bvh_bench.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "bvh_bench")
    if dev is None:
        return 2

    cfg = GravityConfig()
    smi = card_line(dev)
    print(f"device={smi} theta={args.theta}")
    rows = []
    knobs = list(itertools.product(
        args.impls.split(","), _ints(args.group_sizes, None),
        _ints(args.leaf_sizes, 16), _ints(args.batches, 128),
        _ints(args.frontier_widths, None), _ints(args.near_caps, None)))
    for n, dim in parse_cases(args.cases):
        system = random_system(n, dim,
                               generator=torch.Generator().manual_seed(SEED),
                               device=dev)
        for impl, gs, ls, b, fw, nc in knobs:
            row = {"n": n, "dim": dim, "far_impl": impl, "group_size": gs,
                   "leaf_size": ls, "batch": b, "frontier_width": fw,
                   "near_cap": nc}
            line = (f"N={n:>8} {dim}D {impl:<6} G={gs or '-':>4} S={ls:>3} "
                    f"b={b:>4} W={fw or '-':>5} NL={nc or '-':>5} ")

            def run(impl=impl, gs=gs, ls=ls, b=b, fw=fw, nc=nc):
                f = bvh_forces(system.positions, system.masses, cfg,
                               theta=args.theta, far_impl=impl,
                               group_size=gs, leaf_size=ls, batch=b,
                               frontier_width=fw, near_cap=nc)
                return float(f.abs().sum())
            try:
                chk, ms = time_ms(run, dev)
                row.update(ms=ms, checksum=chk)
                line += f"{ms:9.1f} ms  checksum={chk:.6e}"
            except ROW_FAILURES as e:
                row["error"] = row_failure(e)
                line += f"FAILED {row['error']}"
            rows.append(row)
            print(line, flush=True)
    write_record(args.out, {"device": smi, "theta": args.theta,
                            "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
