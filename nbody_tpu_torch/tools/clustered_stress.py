"""Clustered-distribution stress: Plummer N = 1e5 3D on the card.

Port of the repo's ``tools/clustered_stress.py``. The uniform grid tiers'
dense layout refuses this input (``check_grid_capacity`` raises
``GridCapacityError``: the densest leaf cell holds most of the bodies at
the auto level). Two paths must handle it in O(N) memory:

* the adaptive Hilbert-radix BVH (``bvh_forces``: escalating traversal
  capacities, subset re-walk of the overflowed groups), and
* the sparse chunked grid layout (``ops/sparse_grid.py``), reached by
  ``barnes_hut_grid(layout="auto")``.

Records each one's time (CUDA events, one call after a warm-up call) and
its error against a host-numpy f64 oracle on 512 strided sample bodies
(:func:`sampled_oracle_error`), with the dense layout's refusal. With
``--sparse-tune`` it also times ``barnes_hut_sparse`` over (chunk_size,
window); a size that runs out of the card's memory is recorded as that
row's outcome (``common.ROW_FAILURES``), any other error propagates.

Bodies: ``models.plummer_sphere`` (Hénon units, G = 1, softening 4/N) from
``torch.Generator().manual_seed(11)``: the JAX tool's distribution, other
draws. Record: ``results/torch/clustered_stress.json`` by default.

    python -m nbody_tpu_torch.tools.clustered_stress [--n 100000]
        [--theta 0.25] [--sparse-tune] [--skip-sparse] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..models import plummer_sphere
from ..ops.bvh import bvh_forces
from ..ops.grid_tree import (GridCapacityError, auto_leaf_level,
                             barnes_hut_grid, compute_capacity)
from ..ops.sparse_grid import barnes_hut_sparse
from .common import (RESULTS_DIR, ROW_FAILURES, card_line, device_or_none,
                     row_failure, time_ms, write_record)

SEED = 11
#: The JAX tool's ``--sparse-tune`` grid.
TUNE_CHUNKS = (64, 128, 256, 512, 1024)
TUNE_WINDOWS = (8, 16)
#: The JAX tool's gate on both errors.
ERR_GATE = 5e-2


def sampled_oracle_error(positions, masses, forces, cfg,
                         samples: int = 512) -> float:
    """max_i ||F_i - F_i^ref|| / rms(F^ref) over a strided body sample,
    the reference in host numpy float64 against every body (exact,
    O(samples * N), sources in chunks of 65,536). The JAX tool's function,
    on tensors from any device."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    n = positions.shape[0]
    idx = np.arange(0, n, max(1, n // samples))[:samples]
    p = host(positions).astype(np.float64)
    m = host(masses).astype(np.float64)
    soft2 = float(cfg.softening) ** 2
    ref = np.zeros((idx.size, p.shape[1]))
    for s0 in range(0, n, 65_536):  # the whole [S, N, D] is ~12 GB at 1e6
        ps = p[s0:s0 + 65_536]
        d = ps[None, :, :] - p[idx, None, :]
        r2 = np.sum(d * d, axis=-1) + soft2
        r2 = np.where(r2 < 1e-10, np.inf, r2)
        w = m[None, s0:s0 + 65_536] * (r2 ** -1.5)
        ref += np.sum(w[..., None] * d, axis=1)
    ref *= m[idx, None] * cfg.G
    got = host(forces)[idx].astype(np.float64)
    num = np.linalg.norm(got - ref, axis=-1)
    scale = np.sqrt(np.mean(np.sum(ref * ref, axis=-1)))
    return float(np.max(num) / scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.clustered_stress")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--sparse-tune", action="store_true",
                    help="sweep sparse-grid (chunk_size, window) on the card")
    ap.add_argument("--skip-sparse", action="store_true",
                    help="skip the sparse-grid leg")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "clustered_stress.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "clustered_stress")
    if dev is None:
        return 2

    system, cfg = plummer_sphere(
        args.n, 3, generator=torch.Generator().manual_seed(SEED), device=dev)
    pos, mass = system.positions, system.masses
    n, dim = pos.shape

    # 1. The degenerate grid capacity and the dense layout's refusal.
    level = auto_leaf_level(n, dim)
    cap = compute_capacity(pos, level)
    try:
        barnes_hut_grid(pos, mass, cfg, theta=args.theta, layout="dense")
        grid_refused = False
    except GridCapacityError as e:
        grid_refused = "bvh_forces" in str(e)

    # 2. The BVH tier (escalating capacities, subset re-walk).
    bvh_out, bvh_ms = time_ms(
        lambda: bvh_forces(pos, mass, cfg, theta=args.theta), dev)
    bvh_err = sampled_oracle_error(pos, mass, bvh_out, cfg)
    bvh_finite = bool(torch.isfinite(bvh_out).all())

    # 3. The sparse grid through the public driver (layout="auto").
    sp_s = sp_err = sp_finite = None
    if not args.skip_sparse:
        sp_out, sp_ms = time_ms(
            lambda: barnes_hut_grid(pos, mass, cfg, theta=args.theta), dev)
        sp_s = sp_ms / 1e3
        sp_err = sampled_oracle_error(pos, mass, sp_out, cfg)
        sp_finite = bool(torch.isfinite(sp_out).all())
        del sp_out

    # 3b. The (chunk_size, window) sweep of the sparse path.
    tune_rows = []
    if args.sparse_tune:
        for cs in TUNE_CHUNKS:
            for wd in TUNE_WINDOWS:
                row = {"chunk_size": cs, "window": wd}
                try:
                    _, ms = time_ms(lambda cs=cs, wd=wd: barnes_hut_sparse(
                        pos, mass, cfg, theta=args.theta, chunk_size=cs,
                        window=wd), dev)
                    row["time_s"] = ms / 1e3
                    print(f"sparse chunk={cs:>4} window={wd:>3}: "
                          f"{ms / 1e3:8.3f} s", flush=True)
                except ROW_FAILURES as e:
                    row["error"] = row_failure(e)
                    print(f"sparse chunk={cs} window={wd}: {row['error']}",
                          flush=True)
                tune_rows.append(row)

    record = {
        "device": card_line(dev),
        "n": n,
        "dim": dim,
        "theta": args.theta,
        "distribution": "plummer (Henon units, a=1)",
        "grid_auto_leaf_level": level,
        "grid_max_leaf_occupancy": int(cap),
        "dense_grid_guard_refused": bool(grid_refused),
        "bvh_time_s": bvh_ms / 1e3,
        "bvh_finite": bvh_finite,
        "bvh_sampled_norm_error_vs_f64": bvh_err,
        "sparse_grid_time_s": sp_s,
        "sparse_grid_finite": sp_finite,
        "sparse_grid_sampled_norm_error_vs_f64": sp_err,
        "sparse_tune": tune_rows or None,
    }
    write_record(args.out, record)
    for key, value in record.items():
        print(f"  {key}: {value}")
    if not (grid_refused and bvh_finite and bvh_err < ERR_GATE):
        raise AssertionError(f"clustered_stress: dense refusal "
                             f"{grid_refused}, BVH finite {bvh_finite}, "
                             f"error {bvh_err} (gate {ERR_GATE})")
    if not args.skip_sparse and not (sp_finite and sp_err < ERR_GATE):
        raise AssertionError(f"clustered_stress: sparse grid finite "
                             f"{sp_finite}, error {sp_err} (gate {ERR_GATE})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
