#!/usr/bin/env python3
"""The Barnes-Hut reference metric of the JAX package on the port's input.

    JAX_PLATFORMS=cpu python crosscheck/bh_reference_metric.py \
        -N 1000000 --dim 2 [--theta 0.25] [--rows 4096] [--port]

Draws the bodies and the sampled rows exactly as ``chip_smoke.py`` phase
[12] draws its accuracy inputs (``nbody_tpu_torch.state.random_system`` on
a CPU generator seeded with ``BH_SEED``; rows from ``BH_SEED + 1``), runs
the JAX package's ``barnes_hut_grid`` on them at ``theta`` and prints, on
the sampled rows against an f64 oracle (numpy, independent of both
packages): the reference metric (% of bodies with every component within
1%, the JAX package's ``accuracy_percentage``) and the scale-normalized
error. ``--port`` also runs the port's ``barnes_hut_grid`` on the CPU (its
plain near field) on the same input, for a side-by-side reading.

The chip smoke run holds the port's reading on the same rows against the
JAX reading this script gives. Everything runs on the CPU: at N = 1e6 2D
the JAX evaluation takes a few minutes and a few GiB.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# chip_smoke.py draws its Barnes-Hut accuracy inputs from these seeds.
BH_SEED = 1200
ORACLE_ROWS_PER_STEP = 16


def draw(n, dim, rows):
    """The bodies (f32 numpy) and sampled rows of chip_smoke.py phase [12]."""
    import torch
    from nbody_tpu_torch.state import random_system
    bodies = random_system(n, dim,
                           generator=torch.Generator().manual_seed(BH_SEED),
                           device="cpu")
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(
        BH_SEED + 1))[:rows]
    return bodies.positions.numpy(), bodies.masses.numpy(), idx.numpy()


def oracle_forces(pos, mass, rows, g, softening):
    """f64 forces G·m_t·Σ_s m_s (x_s − x_t)(d² + ε²)^{-3/2} on ``rows``;
    pairs with d² < 1e-10 skipped when the softening is 0."""
    p, m = pos.astype(np.float64), mass.astype(np.float64)
    out = np.empty((rows.size, p.shape[1]))
    eps2 = float(softening) ** 2
    for r in range(0, rows.size, ORACLE_ROWS_PER_STEP):
        t = p[rows[r:r + ORACLE_ROWS_PER_STEP]]
        d = p[None, :, :] - t[:, None, :]
        d2 = np.einsum("tsd,tsd->ts", d, d)
        u3 = (d2 + eps2) ** -1.5 if eps2 else np.where(
            d2 < 1e-10, 0.0, np.maximum(d2, 1e-300) ** -1.5)
        out[r:r + t.shape[0]] = np.einsum("tsd,ts->td", d, u3 * m[None, :])
    return g * m[rows][:, None] * out


def metrics(got, want):
    from nbody_tpu.utils.accuracy import accuracy_percentage
    import jax.numpy as jnp
    num = np.linalg.norm(got - want, axis=1).max()
    scale = np.sqrt(np.mean(np.sum(want * want, axis=1)))
    return {"reference_metric_pct": float(accuracy_percentage(
                jnp.asarray(got), jnp.asarray(want))),
            "scale_normalized_err": float(num / scale)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crosscheck/bh_reference_metric.py")
    ap.add_argument("-N", type=int, required=True)
    ap.add_argument("--dim", type=int, choices=(2, 3), required=True)
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--port", action="store_true",
                    help="also run the port's barnes_hut_grid on the CPU")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import nbody_tpu as nb
    from nbody_tpu.ops.grid_tree import barnes_hut_grid

    pos, mass, rows = draw(args.N, args.dim, args.rows)
    cfg = nb.GravityConfig()
    t0 = time.perf_counter()
    want = oracle_forces(pos, mass, rows, cfg.G, cfg.softening)
    t_oracle = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = np.asarray(jax.block_until_ready(barnes_hut_grid(
        jnp.asarray(pos), jnp.asarray(mass), cfg, theta=args.theta)))
    res = {"N": args.N, "dim": args.dim, "theta": args.theta,
           "rows": args.rows, "seed": BH_SEED, "backend": jax.default_backend(),
           "jax": metrics(got[rows].astype(np.float64), want),
           "jax_s": time.perf_counter() - t0, "oracle_s": t_oracle}
    if args.port:
        import torch
        from nbody_tpu_torch import GravityConfig
        from nbody_tpu_torch.ops.grid_tree import barnes_hut_grid as port_bh
        t0 = time.perf_counter()
        have = port_bh(torch.from_numpy(pos), torch.from_numpy(mass),
                       GravityConfig(), theta=args.theta).numpy()
        res["port_cpu"] = metrics(have[rows].astype(np.float64), want)
        res["port_s"] = time.perf_counter() - t0
        res["port_vs_jax_rows_differ"] = int(np.sum(
            np.abs(have[rows] - got[rows]).max(axis=1) > 0))
    res["max_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
