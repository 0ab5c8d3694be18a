"""The readings that the limits of ``correct`` are set from.

* The control: the reference put in the program's place, computed in
  bfloat16 (the step below the configuration's float32), on the cell's own
  bodies and rows. It makes the step the harness checks from the generated
  bodies: forces at x0, the drift, forces at x0 + v0·dt (the positions both
  sides sum over for the second kick), the kick. Its numbers against the
  float64 reference are the upper readings.
* Sound runs: whole runs of the cell (:func:`benchmark.run.run_cell`, a
  short window, no trace) on many seeds in this one process. Their numbers
  are the lower readings.

    python -m benchmark.control --workload <cell> --control-seeds 1 2 3 \
        --sound-seeds 4 5 ... --seconds 2 [--out file.json]

Prints one JSON line a reading and a summary line: each number's largest
sound reading, its smallest control reading and their ratio. Runs on the
card (``--device cpu`` for a small rehearsal with ``--n``); never run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

import torch

from benchmark import catalog, check, inputs, reference


def control_numbers(name: str, seed: int, device="cuda",
                    n: Optional[int] = None,
                    dtype=torch.bfloat16) -> Dict[str, float]:
    """The control's numbers on the cell's bodies drawn from ``seed``."""
    cell, config, _ = catalog.cell(name)
    x0, v0, m = inputs.make_bodies(config, seed, torch.device(device), n=n)
    rows = inputs.sample_rows(x0.shape[0], cell["check"]["rows"], seed).to(
        x0.device)
    dt, G, soft = config["dt"], config["G"], config["softening"]
    x1_all = x0 + v0 * dt
    ref = reference.leapfrog_rows(x0, v0, m, x1_all, rows, dt, G, soft)
    low = reference.leapfrog_rows(x0, v0, m, x1_all, rows, dt, G, soft,
                                  dtype=dtype)
    return check.step_numbers(
        [(low["forces0"], ref["forces0"]), (low["forces1"], ref["forces1"])],
        low["x1"], low["v1"], ref, dt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--sound-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 2
    from benchmark import run
    rows = []
    for seed in args.sound_seeds:
        t = time.perf_counter()
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           device_type=args.device, n=args.n, started=t)
        rows.append({"kind": "sound", "seed": seed, "correct": res["correct"],
                     "numbers": {k: v["value"]
                                 for k, v in res["checks"].items()},
                     "step_ms": res["metrics"].get("step_ms", {}).get("value"),
                     "seconds": time.perf_counter() - t})
        print(json.dumps(rows[-1]), flush=True)
    for seed in args.control_seeds:
        t = time.perf_counter()
        rows.append({"kind": "control", "seed": seed,
                     "numbers": control_numbers(args.workload, seed,
                                                args.device, n=args.n),
                     "seconds": time.perf_counter() - t})
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload}
    for k in check.NUMBERS:
        lower = max((r["numbers"][k] for r in rows if r["kind"] == "sound"),
                    default=None)
        upper = min((r["numbers"][k] for r in rows if r["kind"] == "control"),
                    default=None)
        summary[k] = {"lower": lower, "upper": upper,
                      "ratio": upper / lower if lower and upper else None}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
