"""The BVH's far field at big N: ``far_impl`` point against local.

Port of the repo's ``tools/bvh_far_flip_probe.py``, the evidence behind
``resolve_bvh_far_impl`` ("local" from 5e6 bodies). Times ``bvh_forces``
with each ``--impls`` far field at each ``--cases`` (N, dim): one call
timed with CUDA events after a warm-up call (which settles the escalation
caps), with its sampled f64 oracle error (``clustered_stress.
sampled_oracle_error`` on ``--samples`` bodies; 0 skips it) and the
checksum Σ|F|. A point that runs out of the card's memory is recorded as
that row's outcome (``common.ROW_FAILURES``); any other error propagates.

Rows merge into the record at ``--out``, the newest winning: a new row
replaces the row of the same (n, dim, far_impl, theta). The JAX tool keys
by (n, dim, far_impl), so a run at another θ overwrites its θ = 0.25 rows;
here both are kept.

Bodies: the reference distribution from ``torch.Generator().manual_seed(7)``.

    python -m nbody_tpu_torch.tools.bvh_far_flip_probe
        [--cases 2000000:2,2000000:3] [--theta 0.25] [--samples 256]
        [--impls point,local] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.bvh import bvh_forces
from ..state import random_system
from .clustered_stress import sampled_oracle_error
from .common import (RESULTS_DIR, ROW_FAILURES, card_line, device_or_none,
                     parse_cases, row_failure, time_ms, write_record)

SEED = 7


def row_key(row: dict) -> tuple:
    """The key a merged row is replaced by."""
    return row["n"], row["dim"], row["far_impl"], row["theta"]


def merge_rows(old: list, new: list) -> list:
    """``old`` with each row of ``new`` in place of the row of its key,
    sorted by key."""
    keys = {row_key(r) for r in new}
    return sorted([r for r in old if row_key(r) not in keys] + new,
                  key=row_key)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nbody_tpu_torch.tools.bvh_far_flip_probe")
    ap.add_argument("--cases", default="2000000:2,2000000:3")
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--impls", default="point,local")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "bvh_far_impl_bigN.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "bvh_far_flip_probe")
    if dev is None:
        return 2

    cfg = GravityConfig()
    smi = card_line(dev)
    old = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            old = json.load(f).get("rows", [])
    print(f"device={smi} theta={args.theta}")
    new = []
    for n, dim in parse_cases(args.cases):
        system = random_system(n, dim,
                               generator=torch.Generator().manual_seed(SEED),
                               device=dev)
        for impl in args.impls.split(","):
            row = {"n": n, "dim": dim, "far_impl": impl,
                   "theta": args.theta, "device": smi}
            try:
                f, ms = time_ms(lambda impl=impl: bvh_forces(
                    system.positions, system.masses, cfg, theta=args.theta,
                    far_impl=impl), dev)
                row.update(seconds=ms / 1e3, checksum=float(f.abs().sum()),
                           sampled_oracle_error=(sampled_oracle_error(
                               system.positions, system.masses, f, cfg,
                               samples=args.samples)
                               if args.samples else None))
                del f
            except ROW_FAILURES as e:
                row["error"] = row_failure(e)
            new.append(row)
            print(json.dumps(row), flush=True)
    write_record(args.out, {
        "note": "BVH far_impl probe at big N (uniform cube, seed 7, one "
                "call after a warm-up call, CUDA events; oracle = sampled "
                "host-f64 all-pairs); rows keyed by (n, dim, far_impl, "
                "theta)", "rows": merge_rows(old, new)})
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
