"""The brute-force kernels' variants at N = 2^20 on the card.

Port of the repo's ``tools/brute_variants.py``. The JAX tool scans Pallas
block shapes (``block_t``, ``block_s``, ``s_sub``) of its precise and
symmetric kernels. The port's kernels have no such knobs: their blocks are
fixed by their sources (``SYM_BLOCK`` = 1024 for K1, K2's and K5's tiles in
``csrc/``). So the rows here are every knob ``brute_force_cuda`` does take
(:data:`VARIANTS`): ``mode`` precise (K2) and symmetric (K1), each with the
raw-d² guard on and off, and ``mode="mxu"`` (K5, which takes no guard) with
Morton sorting at ``block_t`` 128, 256 and 512. Before them, the plain
``brute_force_blocked`` (block 1024) gives the oracle's checksum Σ|F|, and
each row gives its checksum's relative difference from it.

Each row: one call timed with CUDA events after a warm-up call (the
oracle: its one call), its pair rate N²/t and its checksum. A variant that
runs out of the card's memory is recorded as that row's outcome
(``common.ROW_FAILURES``); any other error propagates.

Bodies: the reference distribution from ``torch.Generator().manual_seed(7)``.

    python -m nbody_tpu_torch.tools.brute_variants [--n 1048576] [--dim 2]
        [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.brute_force import brute_force_blocked
from ..ops.cuda_brute import brute_force_cuda
from ..state import random_system
from .common import (RESULTS_DIR, ROW_FAILURES, card_line, device_or_none,
                     row_failure, time_ms, time_once, write_record)

SEED = 7
#: (label, keyword arguments of ``brute_force_cuda``).
VARIANTS = (
    ("precise guard", dict(mode="precise", guard=True)),
    ("precise noguard", dict(mode="precise", guard=False)),
    ("symmetric guard", dict(mode="symmetric", guard=True)),
    ("symmetric noguard", dict(mode="symmetric", guard=False)),
    ("mxu sort block_t=128", dict(mode="mxu", sort=True, block_t=128)),
    ("mxu sort block_t=256", dict(mode="mxu", sort=True, block_t=256)),
    ("mxu sort block_t=512", dict(mode="mxu", sort=True, block_t=512)),
)
ORACLE = "plain blocked (oracle)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.brute_variants")
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "brute_variants.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "brute_variants")
    if dev is None:
        return 2

    cfg = GravityConfig()
    system = random_system(args.n, args.dim,
                           generator=torch.Generator().manual_seed(SEED),
                           device=dev)
    pos, mass = system.positions, system.masses
    smi = card_line(dev)
    print(f"device={smi} N={args.n} dim={args.dim} "
          f"softening={cfg.softening}")
    pairs = args.n * args.n
    rows, oracle = [], None
    for name, kw in ((ORACLE, None),) + VARIANTS:
        row = {"label": name, "kwargs": kw}

        def run(kw=kw):
            f = (brute_force_blocked(pos, mass, cfg, block_size=1024)
                 if kw is None else brute_force_cuda(pos, mass, cfg, **kw))
            return float(f.abs().sum())
        try:
            # The oracle's one call is its time: no kernel to build, and at
            # 2^20 it runs for about a minute, which a warm-up would double.
            cs, ms = time_once(run, dev) if kw is None else time_ms(run, dev)
            if kw is None:
                oracle = cs
            rel = abs(cs - oracle) / oracle if oracle else None
            row.update(ms=ms, gpairs_per_s=pairs / (ms * 1e-3) / 1e9,
                       checksum=cs, checksum_rel_diff=rel)
            print(f"{name:28s} {ms:9.1f} ms   {row['gpairs_per_s']:7.1f} "
                  f"Gpair/s   checksum={cs:.4e} (rel diff {rel})",
                  flush=True)
        except ROW_FAILURES as e:
            row["error"] = row_failure(e)
            print(f"{name:28s} FAILED: {row['error']}", flush=True)
        rows.append(row)
    write_record(args.out, {"device": smi, "n": args.n, "dim": args.dim,
                            "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
