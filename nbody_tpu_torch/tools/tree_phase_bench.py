"""Phase-level timing of the grid tree tiers on the card.

Port of the repo's ``tools/tree_phase_bench.py``. Times, separately: the
grid-tree build, then the Barnes-Hut evaluation's ablations (far field
``point`` / ``local`` / ``local_leaf`` × ``_debug_skip`` "" / near / far /
"far,near"), or with ``--fmm`` the FMM's (``m2l`` / ``l2p`` / ``p2p`` /
"m2l,l2p,p2p") at ``--order``. Each row is one call timed with CUDA events
after a warm-up call, and prints K6's launches in the timed call (the
Barnes-Hut near field runs K6 on fp32 bodies on the card; the FMM's
``fmm_accel_sorted`` keeps its plain near field, as the JAX tool's keeps
``p2p_impl="jnp"``).

Bodies: the reference distribution from ``torch.Generator().manual_seed(7)``
(the JAX tool's ``jax.random.key(7)``: the same distribution, other draws).
The level choice is the JAX tool's: ``auto_leaf_level(..., target_occupancy
=32)`` for the FMM, ``k = theta_to_ring(theta)`` for Barnes-Hut.

    python -m nbody_tpu_torch.tools.tree_phase_bench [--n 1048576] [--dim 2]
        [--theta 0.5] [--fmm] [--order 5] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.fmm import fmm_accel_sorted
from ..ops.grid_tree import (auto_leaf_level, build_grid_tree,
                             compute_capacity, grid_tree_accel_sorted,
                             theta_to_ring)
from ..state import random_system
from ..utils.cuda_build import LAUNCHES
from .common import RESULTS_DIR, card_line, device_or_none, time_once, \
    write_record

SEED = 7

#: (``_debug_skip``, far_impl, label): the JAX tool's Barnes-Hut rows.
BH_ABLATIONS = (
    ("", "point", "bh eval full (k={k})"),
    ("near", "point", "bh far only"),
    ("far", "point", "bh near only"),
    ("far,near", "point", "bh scatter/slots only"),
    ("", "local", "bh eval full (local far)"),
    ("near", "local", "bh far only (local)"),
    ("", "local_leaf", "bh eval full (local_leaf far)"),
    ("near", "local_leaf", "bh far only (local_leaf)"),
)
#: (``_debug_skip``, label): the JAX tool's FMM rows.
FMM_ABLATIONS = (
    ("", "fmm full"),
    ("m2l", "fmm skip m2l"),
    ("l2p", "fmm skip l2p"),
    ("p2p", "fmm skip p2p"),
    ("m2l,l2p,p2p", "fmm p2m+sweeps only"),
)


def leaf_level(n: int, dim: int, theta: float, fmm: bool) -> int:
    """The JAX tool's level: occupancy 32 for the FMM (ring 1); for
    Barnes-Hut ``barnes_hut_grid``'s, scaled by the near ring's radius."""
    if fmm:
        return auto_leaf_level(n, dim, target_occupancy=32)
    return auto_leaf_level(n, dim, k=theta_to_ring(theta))


def bh_ablation(tree, k: int, softening: float, far_impl: str,
                skip: str) -> torch.Tensor:
    """One Barnes-Hut row: the sorted accelerations with ``skip``."""
    return grid_tree_accel_sorted(tree, k=k, softening=softening,
                                  multipole="quad", far_impl=far_impl,
                                  _debug_skip=skip)


def fmm_ablation(tree, order: int, softening: float,
                 skip: str) -> torch.Tensor:
    """One FMM row: the sorted accelerations with ``skip``."""
    return fmm_accel_sorted(tree, order=order, ring=1, softening=softening,
                            _debug_skip=skip)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.tree_phase_bench")
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--fmm", action="store_true")
    ap.add_argument("--order", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "tree_phase_bench.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "tree_phase_bench")
    if dev is None:
        return 2

    cfg = GravityConfig()
    system = random_system(args.n, args.dim,
                           generator=torch.Generator().manual_seed(SEED),
                           device=dev)
    pos, mass = system.positions, system.masses
    k = theta_to_ring(args.theta)
    L = leaf_level(args.n, args.dim, args.theta, args.fmm)
    cap = compute_capacity(pos, L)
    soft = float(cfg.softening)
    smi = card_line(dev)
    print(f"device={smi} N={args.n} dim={args.dim} L={L} capacity={cap}")
    record = {"device": smi, "n": args.n, "dim": args.dim,
              "theta": args.theta, "fmm": args.fmm, "order": args.order,
              "leaf_level": L, "capacity": cap, "rows": []}

    def row(label, fn):
        fn()  # warm-up
        before = LAUNCHES["near_field"]
        _, ms = time_once(fn, dev)
        k6 = LAUNCHES["near_field"] - before
        record["rows"].append({"label": label, "ms": ms, "k6_launches": k6})
        print(f"{label:44s} {ms:9.1f} ms   K6 launches {k6}", flush=True)

    row("build_grid_tree", lambda: build_grid_tree(
        pos, mass, L, cap, quad=not args.fmm))
    tree = build_grid_tree(pos, mass, L, cap, quad=not args.fmm)
    if args.fmm:
        for skip, label in FMM_ABLATIONS:
            row(label, lambda skip=skip: fmm_ablation(tree, args.order, soft,
                                                      skip))
    else:
        for skip, far_impl, label in BH_ABLATIONS:
            row(label.format(k=k), lambda skip=skip, far_impl=far_impl:
                bh_ablation(tree, k, soft, far_impl, skip))
    write_record(args.out, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
