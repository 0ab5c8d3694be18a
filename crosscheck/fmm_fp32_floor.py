#!/usr/bin/env python3
"""CPU readings behind the FMM tier's accuracy gates in ``chip_smoke.py``.

    python crosscheck/fmm_fp32_floor.py [--jax] [--plummer] [--threads 4]

For uniform ``random_system`` bodies (seed 1200, 4096 sampled rows from
seed 1201) at (N, dim, leaf level) = (1e5, 2, 5), (2e4, 3, 2), (2e4, 3, 3)
and (1e5, 3, 3), with the port's FMM at order 8 on the CPU, prints:

* the f64 ``fmm_forces`` against an f64 direct sum on the sampled rows
  (scale-normalized; the method's error);
* the fp32 far field (``_debug_skip="p2p"``) against the f64 far field of
  the same tree, over the RMS force (the fp32 floor's far part);
* the largest ratio, over bodies, of that fp32 far error to one fp32 ulp of
  the body's L2P term sum |Σ_m |∇S_m| |w_m|| (the reading ``FMM_FAR_ULPS``
  in ``chip_smoke.py`` is set above).

``--jax`` also reads the JAX package's own fp32 far error on the (2e4, 3,
3) bodies (needs ``JAX_PLATFORMS=cpu``). ``--plummer`` reads the sparse
layouts on Plummer 2e4 3D (G = 1, softening 4/N; seed 1500, rows 1501):
the fp32 and f64 FMM and the fp32 Barnes-Hut θ = 0.25 against the f64
direct sum. Everything runs on the CPU in a few minutes and a few GiB.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nbody_tpu_torch.config import GravityConfig  # noqa: E402
from nbody_tpu_torch.ops import cuda_brute as cb  # noqa: E402
from nbody_tpu_torch.ops import fmm as fm  # noqa: E402
from nbody_tpu_torch.ops import grid_tree as gt  # noqa: E402
from nbody_tpu_torch.state import plummer_system, random_system  # noqa: E402
from nbody_tpu_torch.utils.accuracy import scale_normalized_error  # noqa: E402

ORDER = 8
UNIFORM = [(100_000, 2, 5), (20_000, 3, 2), (20_000, 3, 3), (100_000, 3, 3)]
SEED, ROWS = 1200, 4096
PLUMMER_N, PLUMMER_SEED = 20_000, 1500


def tree_f64(tree):
    def f64(v):
        if isinstance(v, tuple):
            return tuple(f64(x) for x in v)
        return v.double() if torch.is_tensor(v) and v.is_floating_point() \
            else v
    return dataclasses.replace(tree, **{
        f.name: f64(getattr(tree, f.name)) for f in dataclasses.fields(tree)})


def oracle(pos, mass, cfg, rows):
    p64, m64 = pos.double(), mass.double()
    return (cfg.G * m64[rows])[:, None] * cb.pairwise_accel_plain(
        p64[rows], p64, m64, cfg.softening)


def l2p_term_sum(tree64):
    """|Σ_m |∇S_m| |w_m|| per sorted body, the f64 local weights w."""
    dim, L = tree64.dim, tree64.leaf_level
    Tt, m2m = fm._tables(dim, ORDER, torch.float64, "cpu")
    W = fm._m2m(fm._p2m_dense(tree64, ORDER, 1024, Tt), m2m, dim, L)
    lw = fm._l2l(fm._m2l(tree64, W, ORDER, 1), m2m, L,
                 tree64.num_leaf_cells)[tree64.leaf_ids].abs()
    half = tree64.cell_sizes[L] / 2
    y = (tree64.pos_sorted - fm._cell_centers(tree64, tree64.leaf_ids)) / half
    s, ds = fm._interp_and_grad_1d(ORDER, y, Tt)
    s, ds = s.abs().unbind(1), ds.abs().unbind(1)
    return torch.stack([
        (fm._outer_basis([ds[e] if e == d else s[e] for e in range(dim)])
         * lw).sum(-1) / half[d] for d in range(dim)], dim=-1).norm(dim=-1)


def uniform(n, dim, level, cfg):
    bodies = random_system(n, dim, generator=torch.Generator().manual_seed(
        SEED), device="cpu")
    pos, mass = bodies.positions, bodies.masses
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(
        SEED + 1))[:ROWS]
    f64 = fm.fmm_forces(pos.double(), mass.double(), cfg, order=ORDER,
                        leaf_level=level)
    method = float(scale_normalized_error(f64[rows],
                                          oracle(pos, mass, cfg, rows)))
    tree = gt.build_grid_tree(pos, mass, level,
                              gt.compute_capacity(pos, level))
    t64 = tree_f64(tree)
    kw = dict(order=ORDER, softening=cfg.softening)
    far32 = fm.fmm_accel_sorted(tree, _debug_skip="p2p", **kw).double()
    far64 = fm.fmm_accel_sorted(t64, _debug_skip="p2p", **kw)
    full64 = far64 + fm.fmm_accel_sorted(t64, _debug_skip="m2l,l2p", **kw)
    rms = float(full64.norm(dim=-1).pow(2).mean().sqrt())
    err = (far32 - far64).norm(dim=-1)
    ulps = float((err / (2.0 ** -24 * l2p_term_sum(t64))).max())
    print(f"N={n} {dim}D L={level}: f64 FMM vs f64 direct sum {method:.3e}; "
          f"fp32 far field vs f64, same tree {float(err.max()) / rms:.3e} of "
          f"the RMS force; largest body: {ulps:.2f} fp32 ulps of its L2P "
          "term sum", flush=True)
    return pos, mass


def jax_far(pos, mass, level, cfg):
    import jax
    import jax.numpy as jnp
    from nbody_tpu.ops import fmm as jfm
    from nbody_tpu.ops import grid_tree as jgt
    jax.config.update("jax_enable_x64", True)
    p, m = jnp.asarray(pos.numpy()), jnp.asarray(mass.numpy())
    tree = jgt.build_grid_tree(p, m, level, jgt.compute_capacity(p, level))
    t64 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)
    kw = dict(order=ORDER, softening=cfg.softening)
    far32 = np.asarray(jfm.fmm_accel_sorted(tree, _debug_skip="p2p", **kw),
                       np.float64)
    far64 = np.asarray(jfm.fmm_accel_sorted(t64, _debug_skip="p2p", **kw))
    full = far64 + np.asarray(jfm.fmm_accel_sorted(
        t64, _debug_skip="m2l,l2p", **kw))
    err = np.linalg.norm(far32 - far64, axis=-1).max() / np.sqrt(
        (full ** 2).sum(-1).mean())
    print(f"JAX package, N={pos.shape[0]} 3D L={level}: fp32 far field vs "
          f"f64, same tree {err:.3e} of the RMS force", flush=True)


def plummer():
    n = PLUMMER_N
    bodies = plummer_system(n, 3, generator=torch.Generator().manual_seed(
        PLUMMER_SEED), device="cpu")
    pos, mass = bodies.positions, bodies.masses
    cfg = GravityConfig(G=1.0, softening=4.0 / n)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(
        PLUMMER_SEED + 1))[:ROWS]
    want = oracle(pos, mass, cfg, rows)
    for label, got in (
            ("fp32 FMM", fm.fmm_forces(pos, mass, cfg, order=ORDER)),
            ("f64 FMM", fm.fmm_forces(pos.double(), mass.double(), cfg,
                                      order=ORDER)),
            ("fp32 Barnes-Hut theta=0.25", gt.barnes_hut_grid(
                pos, mass, cfg, theta=0.25))):
        err = float(scale_normalized_error(got[rows].double(), want))
        print(f"Plummer N={n} 3D, layout='auto' (sparse): {label} vs f64 "
              f"direct sum {err:.3e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--plummer", action="store_true")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = GravityConfig()
    for n, dim, level in UNIFORM:
        pos, mass = uniform(n, dim, level, cfg)
        if args.jax and (n, dim, level) == (20_000, 3, 3):
            jax_far(pos, mass, level, cfg)
    if args.plummer:
        plummer()
    return 0


if __name__ == "__main__":
    sys.exit(main())
