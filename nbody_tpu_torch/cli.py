"""Benchmark CLI — the flags of ``nbody_tpu.cli`` (reference ``main.cpp:877-951``)
plus ``--device``.

Usage:
    python -m nbody_tpu_torch -d 2 -N 1048576 -m a --device cuda
    python -m nbody_tpu_torch -d 3 -N 100000 -m f --device cuda

Flags:
  -d/--dim {2,3}      spatial dimension (default 2, like the reference)
  -N/--bodies INT     number of bodies (default 1000)
  -a/--accuracy {0,1} compute accuracy vs the brute-force oracle
  -m/--methods STR    tier letters: a=brute force, b=Barnes-Hut, h=BVH, f=FMM
                      (default: all); ``a``, ``b`` and ``f`` are ported so far
  --device {cuda,cpu} where the bodies live (default cuda). Without a GPU,
                      ``cuda`` is an error: the CLI never falls back.

Brute-force methods are skipped for N > 1e6 unless ``-m`` explicitly
includes ``a`` (main.cpp:24, 904-907).
"""

from __future__ import annotations

import argparse
import sys

BRUTE_FORCE_N_GATE = 1_000_000  # main.cpp:24


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody_tpu_torch",
        description="PyTorch/CUDA N-body benchmark "
                    "(tiers: a=brute, b=Barnes-Hut, h=BVH, f=FMM)")
    p.add_argument("-d", "--dim", type=int, default=2, choices=(2, 3))
    p.add_argument("-N", "--bodies", type=int, default=1000)
    p.add_argument("-a", "--accuracy", type=int, default=0, choices=(0, 1))
    p.add_argument("-m", "--methods", type=str, default=None,
                   help="tier letters from 'abhf' (default: all)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup", type=int, default=1,
                   help="warmup runs before timing (0 = cold, like the ref)")
    p.add_argument("--results-dir", type=str, default="results")
    p.add_argument("--no-files", action="store_true",
                   help="don't write results/ files")
    p.add_argument("--dry-run", action="store_true",
                   help="print the resolved method list and exit")
    p.add_argument("--steps", type=int, default=0,
                   help="run a simulation loop for this many steps")
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--integrator", choices=("euler", "leapfrog"),
                   default="leapfrog")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from . import GravityConfig, random_system
    from .bench.harness import run_benchmark
    from .bench.registry import PORTED_TIERS, methods_for_tiers

    tiers = args.methods if args.methods else "abhf"
    bad = set(tiers) - set("abhf")
    if bad:
        print(f"Unknown method tier(s): {''.join(sorted(bad))} "
              f"(valid: a, b, h, f)", file=sys.stderr)
        return 2
    unported = "".join(sorted(set(tiers) - set(PORTED_TIERS)))
    if unported:
        msg = (f"tier(s) {unported} not ported to PyTorch yet (ROADMAP "
               f"queue 1); ported: {PORTED_TIERS}")
        if args.methods is not None:
            print(msg, file=sys.stderr)
            return 2
        print(f"{msg}; left out")
        tiers = "".join(t for t in tiers if t in PORTED_TIERS)

    explicit_brute = args.methods is not None and "a" in args.methods
    if args.bodies > BRUTE_FORCE_N_GATE and "a" in tiers and not explicit_brute:
        print(f"N={args.bodies} > {BRUTE_FORCE_N_GATE}: skipping brute-force "
              f"tier (pass -m with 'a' to override, as in the reference)")
        tiers = tiers.replace("a", "")

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    methods = methods_for_tiers(tiers, device)
    if not methods:
        print(f"No methods registered for the requested tiers on {device}.",
              file=sys.stderr)
        return 2

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"nbody_tpu_torch: N={args.bodies}, dim={args.dim}, device="
          f"{device} ({kind}), methods={[m.name for m in methods]}")
    if args.dry_run:
        return 0

    gen = torch.Generator().manual_seed(args.seed)
    system = random_system(args.bodies, args.dim, generator=gen,
                           device=device)

    results = run_benchmark(
        system, methods,
        gravity=GravityConfig(),
        compute_accuracy=bool(args.accuracy),
        results_dir=None if args.no_files else args.results_dir,
        warmup=args.warmup,
    )

    if args.steps > 0:
        import functools
        from .integrators import simulate
        from .ops.brute_force import brute_force_blocked
        forces_fn = functools.partial(brute_force_blocked,
                                      config=GravityConfig())
        print(f"\nSimulating {args.steps} {args.integrator} steps "
              f"(dt={args.dt}) ...")
        final, _ = simulate(system, forces_fn, args.dt, args.steps,
                            integrator=args.integrator)
        print("final position of body 0:", final.positions[0].cpu().numpy())

    failed = [r for r in results if r.time_s < 0]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
