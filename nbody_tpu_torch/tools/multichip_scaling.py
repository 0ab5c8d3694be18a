"""Multi-device tiers at several shard counts: accuracy and a census of the
collectives each one calls.

Port of the repo's ``tools/multichip_scaling.py``. Every distributed tier
runs on meshes of P shards (default P ∈ {2, 4, 8, 16}); each result is held
to the dense fp32 direct sum (``TIERS``' tolerances, the JAX tool's:
about twice each tier's recorded error), the results at every P to the
smallest P's (the Newton-3 ring to 1e-5, every other tier to twice its
tolerance: a tree's approximation changes with the partition), every tree
tier must read a nonzero error at some P (its far field engaged), and the
mesh's collectives are counted.

The JAX tool runs each (tier, P) in a subprocess with an XLA dump and
counts the collectives in the compiled HLO. The port's mesh is one process
over a device list, so the tiers run here in-process, on P virtual shards
of ``cuda:0`` (``--cpu``: a CPU mesh), and the census is the mesh's own
(``Mesh.census``): per collective its calls and its output bytes summed
over the shards, for one force evaluation. The rings' counts are checked:
the one-sided ring (``ring_one_sided``, the JAX ring with
``symmetric=False``) makes P − 1 ``rotate``s, the Newton-3 rings one
forward and one return ``rotate`` per forward hop.

Shard counts a tier does not take are ``refused`` rows, each checked to
raise ``ValueError``: the grid tiers (leaf level 3 here) need P to divide
the 2^(3·3) leaves, the LET tiers a power of two.

    python -m nbody_tpu_torch.tools.multichip_scaling [--n 4096] \\
        [--mesh-sizes 2,4,8,16] [--cpu] [--out PATH]

Writes ``results/torch/multichip_scaling.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, Optional

import torch

from ..config import GravityConfig
from ..ops.brute_force import brute_force_direct
from ..parallel import (barnes_hut_sharded, bvh_sharded, fmm_sharded,
                        let_barnes_hut, let_bvh, let_fmm, make_mesh,
                        ring_all_pairs_segmented, ring_brute_force)
from ..parallel.ring import _forward_steps
from ..state import random_system
from ..utils.accuracy import scale_normalized_error
from .common import RESULTS_DIR, card_line, device_or_none, sync

SEED = 1
DIM = 3
#: The grid tiers' leaf level here (the JAX tool's knobs).
LEAF_LEVEL = 3

#: tier → tolerance on the scale-normalized error against the direct sum:
#: the JAX tool's gates (about twice each tier's recorded error), and the
#: one-sided ring at the exact rings' 1e-5.
TIERS = {
    "ring_brute_force": 1e-5,
    "ring_one_sided": 1e-5,
    "ring_segmented": 1e-5,
    "sharded_fmm": 5e-4,
    "sharded_barnes_hut": 1.3e-2,
    "sharded_bvh": 3e-3,
    "let_barnes_hut": 1.3e-2,
    "let_fmm": 5e-4,
    "let_bvh": 1e-3,
}
GRID_TIERS = ("sharded_fmm", "sharded_barnes_hut", "let_barnes_hut",
              "let_fmm")
LET_TIERS = ("let_barnes_hut", "let_fmm", "let_bvh")


def tier_fns(pos, mass, cfg, mesh) -> Dict[str, Callable[[], torch.Tensor]]:
    """Each tier's one force evaluation, with the JAX tool's knobs."""
    n, p = pos.shape[0], mesh.num_shards
    return {
        "ring_brute_force": lambda: ring_brute_force(pos, mass, cfg,
                                                     mesh=mesh),
        "ring_one_sided": lambda: ring_brute_force(pos, mass, cfg,
                                                   mesh=mesh,
                                                   symmetric=False),
        # A pair budget that makes >= 2 row chunks a ring step, so the
        # chunked composition is what runs.
        "ring_segmented": lambda: ring_all_pairs_segmented(
            pos, mass, cfg, mesh=mesh,
            pair_budget=max(128, n // p // 2) * (n // p)),
        "sharded_fmm": lambda: fmm_sharded(pos, mass, cfg, mesh=mesh,
                                           order=6, leaf_level=LEAF_LEVEL),
        "sharded_barnes_hut": lambda: barnes_hut_sharded(
            pos, mass, cfg, mesh=mesh, theta=0.5, leaf_level=LEAF_LEVEL),
        "sharded_bvh": lambda: bvh_sharded(pos, mass, cfg, mesh=mesh,
                                           theta=0.5, group_size=8),
        "let_barnes_hut": lambda: let_barnes_hut(
            pos, mass, cfg, mesh=mesh, theta=0.5, leaf_level=LEAF_LEVEL),
        "let_fmm": lambda: let_fmm(pos, mass, cfg, mesh=mesh, order=6,
                                   leaf_level=LEAF_LEVEL),
        "let_bvh": lambda: let_bvh(pos, mass, cfg, mesh=mesh, theta=0.5),
    }


def refusal(tier: str, p: int) -> Optional[str]:
    """Why ``tier`` does not take ``p`` shards, or None."""
    if tier in LET_TIERS and p & (p - 1):
        return f"the LET tiers need a power-of-two shard count, not {p}"
    if tier in GRID_TIERS and (1 << (DIM * LEAF_LEVEL)) % p:
        return (f"{p} shards do not split the {1 << (DIM * LEAF_LEVEL)} "
                f"leaves of level {LEAF_LEVEL}")
    return None


def expected_rotates(tier: str, p: int) -> Optional[int]:
    """The ``rotate`` calls of one ring evaluation on ``p`` shards."""
    if tier == "ring_one_sided":
        return p - 1
    if tier in ("ring_brute_force", "ring_segmented"):
        return 2 * _forward_steps(p)
    return None


def run(n: int, mesh_sizes, devices_for: Callable[[int], list],
        log=print) -> dict:
    """Every tier at every mesh size; raises AssertionError at the first
    failed check. Returns the record's ``tiers``."""
    cfg = GravityConfig()
    dev = devices_for(1)[0]
    system = random_system(n, DIM, generator=torch.Generator().manual_seed(
        SEED), device=dev)
    pos, mass = system.positions, system.masses
    want = brute_force_direct(pos, mass, cfg)
    results: Dict[str, dict] = {t: {} for t in TIERS}
    forces_at: Dict[str, Dict[int, torch.Tensor]] = {t: {} for t in TIERS}
    for p in mesh_sizes:
        mesh = make_mesh(devices_for(p))
        fns = tier_fns(pos, mass, cfg, mesh)
        for tier, tol in TIERS.items():
            why = refusal(tier, p)
            if why is not None:
                try:
                    fns[tier]()
                except ValueError as e:
                    results[tier][str(p)] = {"refused": str(e)}
                    log(f"P={p:<2} {tier:<20} refused: {e}")
                    continue
                raise AssertionError(f"{tier} at P={p} ran; expected a "
                                     f"refusal ({why})")
            with mesh.census() as census:
                out = fns[tier]()
                sync(dev)
            err = float(scale_normalized_error(out, want))
            if not err < tol:
                raise AssertionError(f"{tier} at P={p}: error {err:.3e} >= "
                                     f"{tol:g} against the direct sum")
            rot = expected_rotates(tier, p)
            if rot is not None and census.get("rotate", {}).get(
                    "count") != rot:
                raise AssertionError(f"{tier} at P={p}: census {census}, "
                                     f"expected {rot} rotates")
            forces_at[tier][p] = out
            results[tier][str(p)] = {
                "err_vs_direct": err, "tolerance": tol,
                "collectives": census,
                "collective_out_bytes_per_step":
                    sum(c["out_bytes"] for c in census.values())}
            log(f"P={p:<2} {tier:<20} err {err:.2e} < {tol:.0e}  "
                f"collectives {census}")

    for tier, by_p in forces_at.items():
        if not by_p:
            continue
        p0 = min(by_p)
        limit = 1e-5 if tier == "ring_brute_force" else 2 * TIERS[tier]
        for p, out in by_p.items():
            drift = float(scale_normalized_error(out, by_p[p0]))
            results[tier][str(p)][f"drift_vs_P{p0}"] = drift
            if not drift < limit:
                raise AssertionError(f"{tier}: P={p} against P={p0} drifts "
                                     f"{drift:.3e} >= {limit:g}")
        if not tier.startswith("ring"):
            errs = [results[tier][str(p)]["err_vs_direct"] for p in by_p]
            if not max(errs) > 0.0:
                raise AssertionError(f"{tier}: the far field was engaged at "
                                     f"no mesh size (error 0 everywhere)")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--mesh-sizes", default="2,4,8,16")
    ap.add_argument("--cpu", action="store_true",
                    help="a CPU mesh instead of virtual shards of cuda:0")
    ap.add_argument("--out", default=os.path.join(
        RESULTS_DIR, "multichip_scaling.json"))
    args = ap.parse_args(argv)
    dev = device_or_none("cpu" if args.cpu else "cuda", "multichip_scaling")
    if dev is None:
        return 2
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    mesh_sizes = tuple(int(p) for p in args.mesh_sizes.split(","))
    card = card_line(dev)
    print(f"multichip_scaling: N={args.n} {DIM}D, meshes of "
          f"{list(mesh_sizes)} shards of {dev}, {card}")
    tiers = run(args.n, mesh_sizes, lambda p: [dev] * p)
    record = {
        "n_bodies": args.n, "dim": DIM, "mesh_sizes": list(mesh_sizes),
        "backend": (f"virtual shards of one card: {card}"
                    if dev.type == "cuda" else "cpu mesh"),
        "methodology": (
            "one process over a device list; each tier's collectives "
            "counted by Mesh.census during one force evaluation (calls, "
            "output bytes summed over the shards); accuracy = scale-"
            "normalized error against the dense fp32 direct sum; drift = "
            "the same metric against the smallest mesh's result"),
        "tiers": tiers,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
