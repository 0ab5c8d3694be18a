"""The per-step floor at small N (N = 1000): where a step's time goes.

Port of the repo's ``tools/smalln_floor.py``. Variants:

* ``trivial``: Euler steps whose "force" is p·1e-30, the floor of a step
  (the integrator's launches and the state's round trips);
* ``brute_force_blocked`` / ``brute_force_direct``: the plain paths;
* ``brute_force_cuda_symmetric``: K1, ``brute_force_cuda(mode=
  "symmetric")``;
* ``fused_smalln_simulate``: K4, K steps inside one launch.

The first four run K Euler steps captured as one CUDA graph
(``device_step_bench.GraphSteps``, the port's counterpart of the JAX
tool's one ``lax.scan`` dispatch) and time its replay; K4 is one launch of
K steps. Each time is the least of 5 CUDA-event times after a warm-up run,
and the per-step time comes from differencing K_LO and K_HI steps
(:func:`per_step`), so the fixed cost of a dispatch cancels. Each graph
variant's state after K_LO replayed steps is also held against K_LO eager
steps (``graph_vs_eager_rel``, the largest difference over the largest
value). Needs the card (graphs, events): ``--device cpu`` exits 2.

The record's keys are the port's functions; :data:`JAX_KEYS` maps them to
the JAX record's (``artifacts/smalln_floor.json``).

Bodies: the reference distribution from ``torch.Generator().manual_seed(42)``.

    python -m nbody_tpu_torch.tools.smalln_floor [--n 1000] [--dim 2]
        [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.brute_force import brute_force_blocked, brute_force_direct
from ..ops.cuda_brute import brute_force_cuda, fused_smalln_simulate
from ..state import random_system
from .common import RESULTS_DIR, card_line, device_or_none, time_ms, \
    write_record
from .device_step_bench import GraphSteps, euler_steps

K_LO, K_HI = 256, 4096
DT = 1e-6
SEED = 42
REPS = 5

#: The port's record keys → the JAX record's.
JAX_KEYS = {"trivial": "trivial", "brute_force_blocked": "jnp_blocked",
            "brute_force_direct": "jnp_direct",
            "brute_force_cuda_symmetric": "pallas",
            "fused_smalln_simulate": "fused"}


def per_step(t_lo: float, t_hi: float, k_lo: int = K_LO,
             k_hi: int = K_HI) -> float:
    """The differenced time a step: (t_hi − t_lo) / (k_hi − k_lo)."""
    return (t_hi - t_lo) / (k_hi - k_lo)


def graph_variants(cfg: GravityConfig) -> dict:
    """The graph-captured variants: record key → forces(positions, masses)."""
    return {
        "trivial": lambda p, m: p * 1e-30,
        "brute_force_blocked": lambda p, m: brute_force_blocked(
            p, m, cfg, block_size=1024),
        "brute_force_direct": lambda p, m: brute_force_direct(p, m, cfg),
        "brute_force_cuda_symmetric": lambda p, m: brute_force_cuda(
            p, m, cfg, mode="symmetric"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.smalln_floor")
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "smalln_floor.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "smalln_floor")
    if dev is None:
        return 2
    if dev.type != "cuda":
        print("smalln_floor: the graph rows and the CUDA-event times need "
              "the card", file=sys.stderr)
        return 2

    cfg = GravityConfig()
    system = random_system(args.n, args.dim,
                           generator=torch.Generator().manual_seed(SEED),
                           device=dev)
    smi = card_line(dev)
    results = {"device": smi, "n": args.n, "dim": args.dim, "k_lo": K_LO,
               "k_hi": K_HI, "jax_keys": JAX_KEYS,
               "ref_cuda_step_s_n1e3_2d": 0.000449}
    print(f"smalln_floor N={args.n} {args.dim}D on {smi}")

    def report(name, t_lo, t_hi, **extra):
        per = per_step(t_lo, t_hi)
        results[name] = {"t_scan_lo_s": t_lo, "t_scan_hi_s": t_hi,
                         "per_step_s": per, **extra}
        print(f"{name:<28} per-step {per * 1e6:9.3f} us  (raw "
              f"{t_lo:.6f}/{t_hi:.6f} s)", flush=True)

    for name, fn in graph_variants(cfg).items():
        stepper = GraphSteps(fn, system, DT)
        got, t_lo = time_ms(lambda: stepper.run(K_LO), dev, reps=REPS)
        want = euler_steps(fn, system, K_LO, DT)
        rel = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in ((got.positions, want.positions),
                               (got.velocities, want.velocities)))
        _, t_hi = time_ms(lambda: stepper.run(K_HI), dev, reps=REPS)
        report(name, t_lo / 1e3, t_hi / 1e3, graph_vs_eager_rel=rel)
        del stepper

    def fused(k):
        return fused_smalln_simulate(
            system.positions, system.velocities, system.masses, dt=DT,
            num_steps=k, g=float(cfg.G), softening=float(cfg.softening),
            integrator="euler")

    (_, t_lo), (_, t_hi) = (time_ms(lambda k=k: fused(k), dev, reps=REPS)
                            for k in (K_LO, K_HI))
    report("fused_smalln_simulate", t_lo / 1e3, t_hi / 1e3)
    write_record(args.out, results)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
