"""Win/loss audit: the port's aggregated matrix against the reference's.

Port of the repo's ``tools/compare_vs_baseline.py``. Joins the port's
sweep aggregate (``bench.analysis`` over ``tools/run_full_sweep.py``'s
files; schema ``Bodies,Method,Dimension,Time(s),Accuracy(%),Runs``)
against the reference suite's aggregate
(``Bodies,Method,Dimension,Average Runtime (s)``, the deliverable of
``run_simulations.sh:26-60`` and its notebook), and prints one line per
matrix cell: the port's time, the best reference competitor of the same
family, and the speedup. Losing cells are flagged, and the exit code is 1
when there is one (2 when the reference aggregate cannot be read).

Family mapping (port method → reference family):
  BruteForce_Torch / BruteForce_CUDA → best of BruteForce_* (CUDA included)
  BarnesHut_Grid (θ = 0.25)          → best of BarnesHut_* (reference θ = 0.25)
  BarnesHut_Grid_Theta05             → the same family (no θ = 0.5 twin)
  BVH_Radix                          → best of BVH_*
  FMM_Chebyshev                      → best of FMM_*

Small N: where ``device_step_times.csv`` (``tools/device_step_bench.py``:
K steps differenced) has a one-dispatch row for a cell with
N ≤ ``DEVICE_STEP_N_CUTOFF``, the cell is scored on that per-step device
time, and the wall-clock time is printed beside it: at small N the wall
clock of one evaluation is launch and host time more than the card's work.
A one-dispatch row is a ``Dispatch == graph`` row of the port's file, or
any row of the JAX tool's file (one ``lax.scan`` each, no ``Dispatch``
column). An ``eager`` row (the tree tiers: K eager steps on the host's
clock, launches and host reads included) is wall time too; it is printed
beside the wall time and not scored.

    python -m nbody_tpu_torch.tools.compare_vs_baseline \\
        [--ours results/torch/sweep/aggregated_results.csv] \\
        [--ref PATH] [--device-steps results/torch/device_step_times.csv]

``--ref`` defaults to ``bench.analysis.REF_AGGREGATE`` (the environment's
``NBODY_REF_AGGREGATE``).
"""

from __future__ import annotations

import argparse
import csv
import os

from ..bench.analysis import REF_AGGREGATE, load_reference_best
from .common import RESULTS_DIR

FAMILY = {
    "BruteForce_Torch": "BruteForce",
    "BruteForce_CUDA": "BruteForce",
    "BarnesHut_Grid": "BarnesHut",
    "BarnesHut_Grid_Theta05": "BarnesHut",
    "BVH_Radix": "BVH",
    "FMM_Chebyshev": "FMM",
}

#: Up to this N a cell with a device-step row is scored on it.
DEVICE_STEP_N_CUTOFF = 100_000


def load_ours(path):
    rows = {}
    with open(path) as f:
        for r in csv.DictReader(f):
            key = (int(r["Bodies"]), r["Method"], int(r["Dimension"]))
            rows[key] = (float(r["Time(s)"]), r.get("Accuracy(%)", ""))
    return rows


def load_device_steps(path):
    """{(Bodies, Method, Dimension): (per-step seconds, one dispatch?)}
    from the device-step file (either schema); {} when absent."""
    rows = {}
    try:
        with open(path) as f:
            for r in csv.DictReader(f):
                try:
                    rows[(int(r["Bodies"]), r["Method"],
                          int(r["Dimension"]))] = (
                        float(r["StepTime(s)"]),
                        r.get("Dispatch") in (None, "graph"))
                except (KeyError, ValueError):
                    continue
    except OSError:
        return {}
    return rows


def compare(ours, ref, dev, log=print):
    """(losses, uncontested, device-step-scored) of the audit, one line
    logged per cell; a loss is (n, method, dim, ours s, ref s, ref method,
    speedup)."""
    losses = []
    uncontested = dev_scored = 0
    log(f"{'N':>9} {'D':>2} {'method':<24} {'scored(s)':>10} "
        f"{'wall(s)':>9} {'ref best(s)':>11} {'ref method':<22} "
        f"{'speedup':>8}")
    for (n, m, d) in sorted(ours, key=lambda k: (k[0], k[2], k[1])):
        t_wall, _acc = ours[(n, m, d)]
        t_step, one_dispatch = dev.get((n, m, d), (None, False))
        t_scored, note = t_wall, ""
        if n <= DEVICE_STEP_N_CUTOFF and t_step is not None:
            if one_dispatch:
                t_scored, note = t_step, "dev-step"
                dev_scored += 1
            else:
                note = f"eager-step {t_step:.4g}s (not scored)"
        refkey = (n, FAMILY.get(m), d)
        if refkey not in ref:
            uncontested += 1
            log(f"{n:>9} {d:>2} {m:<24} {t_scored:>10.4f} "
                f"{t_wall:>9.4f} {'—':>11} {'(no ref row)':<22} "
                f"{'—':>8} {note}")
            continue
        t_ref, m_ref = ref[refkey]
        sp = t_ref / t_scored if t_scored > 0 else float("inf")
        if sp < 1.0:
            losses.append((n, m, d, t_scored, t_ref, m_ref, sp))
        log(f"{n:>9} {d:>2} {m:<24} {t_scored:>10.4f} "
            f"{t_wall:>9.4f} {t_ref:>11.4f} {m_ref:<22} "
            f"{sp:>7.2f}x {note}{'   *** LOSS ***' if sp < 1.0 else ''}")
    return losses, uncontested, dev_scored


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ours", default=os.path.join(
        RESULTS_DIR, "sweep", "aggregated_results.csv"))
    ap.add_argument("--ref", default=REF_AGGREGATE)
    ap.add_argument("--device-steps", default=os.path.join(
        RESULTS_DIR, "device_step_times.csv"))
    args = ap.parse_args(argv)

    ours = load_ours(args.ours)
    dev = load_device_steps(args.device_steps)
    ref = load_reference_best(args.ref)
    if not ref:
        print(f"reference aggregate not readable at {args.ref}; "
              "nothing to compare against")
        return 2
    losses, uncontested, dev_scored = compare(ours, ref, dev)
    print(f"\n{len(ours)} cells: {len(ours) - len(losses) - uncontested} "
          f"wins, {len(losses)} losses, {uncontested} uncontested "
          f"(no reference row at that (N, dim)); {dev_scored} cells "
          f"scored on the per-step device time of one dispatch (N <= "
          f"{DEVICE_STEP_N_CUTOFF}, wall time shown alongside).")
    if losses:
        print("\nLosing cells:")
        for (n, m, d, to, tr, mr, sp) in losses:
            print(f"  N={n} {d}D {m}: {to:.3f}s vs {mr} {tr:.3f}s "
                  f"({sp:.2f}x)")
    return 1 if losses else 0


if __name__ == "__main__":
    raise SystemExit(main())
