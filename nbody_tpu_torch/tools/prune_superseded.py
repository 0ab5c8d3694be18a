"""Retire superseded benchmark run files before re-aggregation.

Port of the repo's ``tools/prune_superseded.py`` (the same ``scan``,
``plan`` and ``main``; plain Python, kept as the port's own copy).
``bench.analysis.load_results`` averages every ``*.csv`` of the results
directory, so after a re-measurement the stale rows of an earlier
generation would be averaged with the fresh ones. This tool enforces
"newest generation wins, per cell":

- A run file covers one (method, N, dim, accuracy?) cell
  (``run_r<G>{a,f}p<pass>_<method>_N_<n>_<d>D.csv``, as
  ``tools/run_full_sweep.py`` names them; the {a,f} letter is the accuracy
  flag, <G> the generation).
- A file is superseded when a higher generation's file holds a valid row
  (Time >= 0) for the same cell: it moves, with its ``.out`` twin, to
  ``<results>/superseded/``, which the aggregator's top-level glob never
  reads.
- Empty or row-less CSVs are retired unconditionally.

    python -m nbody_tpu_torch.tools.prune_superseded \\
        [--results-dir results/torch/sweep] [--dry-run]
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import shutil

from .common import RESULTS_DIR

NAME_RE = re.compile(
    r"^run_r(?P<gen>\d+)(?P<acc>[af])p(?P<pass>\d+)_(?P<method>.+)"
    r"_N_(?P<n>\d+)_(?P<dim>\d)D\.csv$")


def scan(results_dir):
    """[(path, gen, cell, valid)] for every run CSV; cell =
    (method, n, dim, acc)."""
    out = []
    for name in sorted(os.listdir(results_dir)):
        m = NAME_RE.match(name)
        if not m:
            continue
        path = os.path.join(results_dir, name)
        cell = (m["method"], int(m["n"]), int(m["dim"]), m["acc"] == "a")
        valid = False
        try:
            with open(path) as f:
                for row in csv.DictReader(f):
                    try:
                        if float(row["Time(s)"]) >= 0:
                            valid = True
                            break
                    except (KeyError, ValueError, TypeError):
                        continue
        except OSError:
            pass
        out.append((path, int(m["gen"]), cell, valid))
    return out


def plan(results_dir):
    """Paths to retire: empty/invalid files + files outdone by a newer
    generation's valid file for the same cell."""
    files = scan(results_dir)
    newest_valid = {}
    for _path, gen, cell, valid in files:
        if valid:
            newest_valid[cell] = max(newest_valid.get(cell, 0), gen)
    retire = []
    for path, gen, cell, valid in files:
        if not valid:
            retire.append((path, "no valid rows"))
        elif gen < newest_valid.get(cell, 0):
            retire.append((path, f"superseded by r{newest_valid[cell]}"))
    return retire


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results-dir", default=os.path.join(RESULTS_DIR,
                                                          "sweep"))
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    retire = plan(args.results_dir)
    dest = os.path.join(args.results_dir, "superseded")
    for path, why in retire:
        targets = [path]
        out_twin = path[:-4] + ".out"
        if os.path.exists(out_twin):
            targets.append(out_twin)
        for t in targets:
            print(f"{'would retire' if args.dry_run else 'retire'}: "
                  f"{os.path.basename(t)}  ({why})")
            if not args.dry_run:
                os.makedirs(dest, exist_ok=True)
                shutil.move(t, os.path.join(dest, os.path.basename(t)))
    print(f"{len(retire)} run files retired -> {dest}"
          + (" (dry run)" if args.dry_run else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
