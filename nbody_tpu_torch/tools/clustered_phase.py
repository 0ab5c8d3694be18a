"""Phase split of one clustered (Plummer) BVH force evaluation on the card.

Port of the repo's ``tools/clustered_phase.py``. Decomposes one production
evaluation:

* ``build``: ``build_bvh`` (keys, radix sort, ANSV, moments);
* ``fused_base``: the driver's first walk at the default capacities
  (``_bvh_eval``: build, walk, unsort), with its overflow stats: the
  groups that overflowed, the high-water frontier and near counts;
* ``escalated`` / ``esc_no_near`` / ``esc_no_far`` / ``esc_walk_only``:
  the ``_debug_skip`` ablations of ``bvh_accel_sorted`` at the escalated
  capacities over the overflowed groups padded to a power of two (the JAX
  tool's expressions, :func:`escalated_caps` and :func:`padded_subset`);
* ``end_to_end``: ``bvh_forces``, and again with ``caps_state`` warm
  (what steps 2..K of a stepping loop pay).

Each phase is one call timed with CUDA events after a warm-up call (the
JAX tool's cached second run; the warm-up call is what fills
``caps_state``). The walk settings (:func:`walk_settings`), the subset
padding and the timer are shared with ``tools/bvh_probe.py``.

Bodies: ``plummer_system`` from ``torch.Generator().manual_seed(3)`` at
G = 1, softening 0.05: the JAX tool's distribution, other draws. Record:
``results/torch/clustered_phase.json`` by default.

    python -m nbody_tpu_torch.tools.clustered_phase [--n 1048576] [--dim 3]
        [--theta 0.5] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Tuple

import numpy as np
import torch

from ..config import GravityConfig
from ..ops.bvh import _bvh_eval, build_bvh, bvh_accel_sorted, bvh_forces
from ..ops.keys import MAX_BITS
from ..state import plummer_system
from .common import RESULTS_DIR, card_line, device_or_none, time_ms, \
    write_record

SEED = 3
LEAF_SIZE, BATCH = 16, 128
#: The four subset re-walks: (record key, ``_debug_skip``).
SUBSET_ABLATIONS = (("escalated", ""), ("esc_no_near", "near"),
                    ("esc_no_far", "far"), ("esc_walk_only", "near,far"))


def walk_settings(n: int, dim: int, theta: float, softening: float,
                  far_impl: str) -> Tuple[int, dict]:
    """(the default frontier and near capacity, the walk's keyword
    arguments) of ``bvh_forces`` at its defaults: leaf 16, groups of
    min(1024, N), batches of 128, quadrupole sources."""
    cap = min(1024 if dim == 2 else 8192, 2 * n)
    return cap, dict(leaf_size=LEAF_SIZE, theta=float(theta),
                     softening=float(softening), group_size=min(1024, n),
                     batch=BATCH, multipole="quad", far_impl=far_impl)


def escalated_caps(n: int, w: int, nl: int, need_w: int,
                   need_nl: int) -> Tuple[int, int]:
    """The JAX tool's escalated capacities: each doubled past its
    high-water count where that count is over it, bounded by 2N."""
    w2 = min(2 * n, max(2 * w, 2 * need_w)) if need_w > w else w
    nl2 = min(2 * n, max(2 * nl, 2 * need_nl)) if need_nl > nl else nl
    return w2, nl2


def padded_subset(ids: np.ndarray) -> np.ndarray:
    """The overflowed group ids padded to a power of two with copies of
    the first (the escalation driver's subset)."""
    m = 1 << max(0, int(ids.size - 1).bit_length())
    return np.concatenate([ids, np.full(m - ids.size, ids[0], ids.dtype)])


def base_walk(pos, mass, cfg, walk: dict, w: int, nl: int):
    """The driver's first walk: (forces, max frontier, max near count,
    overflowed group ids, tree)."""
    dim = pos.shape[1]
    forces, maxw, ncnt, g_over, tree = _bvh_eval(
        pos, mass, float(cfg.G), key_bits=dim * MAX_BITS[dim], quad=True,
        frontier_width=w, near_cap=nl, **walk)
    return (forces, int(maxw), int(ncnt),
            np.nonzero(g_over.cpu().numpy())[0], tree)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.clustered_phase")
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "clustered_phase.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "clustered_phase")
    if dev is None:
        return 2

    cfg = GravityConfig(G=1.0, softening=0.05)
    system = plummer_system(args.n, args.dim,
                            generator=torch.Generator().manual_seed(SEED),
                            device=dev)
    pos, mass = system.positions, system.masses
    n, dim = pos.shape
    w, walk = walk_settings(n, dim, args.theta, cfg.softening, "point")
    nl = w
    res = {"device": card_line(dev), "n": n, "dim": dim,
           "theta": args.theta, "distribution": "plummer",
           "group_size": walk["group_size"], "base_frontier_width": w,
           "base_near_cap": nl}
    print(f"clustered_phase N={n} {dim}D theta={args.theta} on "
          f"{res['device']}")

    # 1. The build.
    tree, ms = time_ms(lambda: build_bvh(pos, mass, dim * MAX_BITS[dim],
                                        quad=True), dev)
    res["build_s"] = ms / 1e3
    print(f"build            {ms / 1e3:7.3f} s")

    # 2. The first walk at the default capacities and its overflow stats.
    (_, need_w, need_nl, ids, tree), ms = time_ms(
        lambda: base_walk(pos, mass, cfg, walk, w, nl), dev)
    res["fused_base_s"] = ms / 1e3
    res["overflow"] = {"groups_overflowed": int(ids.size),
                       "groups_total": -(-n // walk["group_size"]),
                       "need_frontier_width": need_w,
                       "need_near_cap": need_nl}
    print(f"fused base       {ms / 1e3:7.3f} s   overflow {ids.size} groups, "
          f"need W={need_w} NL={need_nl}")

    # 3. The escalated subset's re-walks.
    w2, nl2 = escalated_caps(n, w, nl, need_w, need_nl)
    res["escalated_caps"] = {"frontier_width": w2, "near_cap": nl2,
                             "subset_groups": int(ids.size)}
    if ids.size:
        gids = torch.as_tensor(padded_subset(ids), device=dev)
        for name, skip in SUBSET_ABLATIONS:
            _, ms = time_ms(lambda skip=skip: bvh_accel_sorted(
                tree, frontier_width=w2, near_cap=nl2, return_stats=True,
                group_ids=gids, _debug_skip=skip, **walk), dev)
            res[name + "_s"] = ms / 1e3
            print(f"{name:<16} {ms / 1e3:7.3f} s")
    del tree

    # 4. Production end to end, and with the stepping caps warm (the
    # warm-up call fills caps_state).
    _, ms = time_ms(lambda: bvh_forces(pos, mass, cfg, theta=args.theta), dev)
    res["end_to_end_s"] = ms / 1e3
    print(f"end_to_end       {ms / 1e3:7.3f} s")
    caps: dict = {}
    _, ms = time_ms(lambda: bvh_forces(pos, mass, cfg, theta=args.theta,
                                       caps_state=caps), dev)
    res["end_to_end_caps_warm_s"] = ms / 1e3
    res["caps_state"] = dict(caps)
    print(f"e2e caps-warm    {ms / 1e3:7.3f} s   caps={caps}")
    write_record(args.out, res)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
