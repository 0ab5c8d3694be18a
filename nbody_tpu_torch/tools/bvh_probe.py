"""One BVH force evaluation on the card, split into its phases, beside the
sparse grid's Barnes-Hut on the same bodies.

    python -m nbody_tpu_torch.tools.bvh_probe -N 1000000 --dim 3 --plummer \\
        [--theta 0.25] [--timeout 300] [--out chiprun_out/bvh_probe.json]

Bodies: ``plummer_system`` in Henon units (G = 1, softening 4/N, the shape
of the JAX package's ``artifacts/clustered_stress*.json``) or, without
``--plummer``, the reference's uniform ``random_system`` at the default
gravity. Each path runs in a process of its own, cut after ``--timeout``
seconds (a cut path is recorded as such):

* ``bvh``: the phases of ``bvh_forces`` at its defaults, each printed as
  it ends: the build; the first walk at the default capacities without and
  with pass 2 (its high-water counts and overflowed groups); each
  escalation re-walk of the overflowed groups; then one whole evaluation
  with its host read-backs and peak memory.
* ``sparse``: ``barnes_hut_grid`` under ``layout="auto"`` (the sparse
  layout on clustered bodies), cold and once more.

Times are CUDA-event times of single runs (the first of each includes
whatever warms up), printed with the card's name and power limit; the JSON
holds every number. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from .clustered_phase import padded_subset, walk_settings
from .common import card_line, time_once


def _bodies(n, dim, plummer, seed, dev):
    from ..config import GravityConfig
    from ..state import plummer_system, random_system
    gen = torch.Generator().manual_seed(seed)
    if plummer:
        return (plummer_system(n, dim, generator=gen, device=dev),
                GravityConfig(G=1.0, softening=4.0 / n))
    return random_system(n, dim, generator=gen, device=dev), GravityConfig()


def _emit(**rec) -> None:
    """One phase's numbers, printed as it ends (a cut run keeps them)."""
    print(json.dumps(rec), flush=True)


def _run_bvh(pos, mass, cfg, theta) -> None:
    """The phases of ``bvh_forces`` at its defaults, one by one: the build,
    the first walk at the default capacities without and with pass 2, each
    escalation re-walk of the overflowed groups (the driver's doubling
    rule), then one whole evaluation with its read-backs and peak memory."""
    import numpy as np

    from ..ops import bvh
    n, dim = pos.shape
    kb = dim * bvh.MAX_BITS[dim]
    cap, walk = walk_settings(n, dim, theta, cfg.softening,
                              bvh.resolve_bvh_far_impl(n))
    walk["return_stats"] = True
    dev = pos.device
    tree, ms = time_once(lambda: bvh.build_bvh(pos, mass, kb, quad=True),
                         dev)
    _emit(phase="build", ms=ms)
    _, ms = time_once(lambda: bvh.bvh_accel_sorted(
        tree, **walk, frontier_width=cap, near_cap=cap, _debug_skip="near"),
        dev)
    _emit(phase="walk_no_near", ms=ms, caps=cap)
    (_, maxw, ncnt, over), ms = time_once(lambda: bvh.bvh_accel_sorted(
        tree, **walk, frontier_width=cap, near_cap=cap), dev)
    need_w, need_nl = int(maxw), int(ncnt)
    ids = np.nonzero(over.cpu().numpy())[0]
    _emit(phase="walk", ms=ms, max_frontier=need_w, max_near=need_nl,
          overflowed_groups=int(ids.size), groups=over.numel())
    # bvh_forces's escalation: the overflowed groups, padded to a power of
    # two, re-walk with capacities doubled past the high-water counts.
    def chunked(width):
        wc = min(width, 256)
        return -(-width // wc) * wc

    def nl_chunked(c):
        k = min(c, 2048 // walk["leaf_size"])
        return -(-c // k) * k

    w2, nl2 = cap, cap
    if ids.size and (need_w > chunked(cap) or need_nl > nl_chunked(cap)):
        gids = torch.as_tensor(padded_subset(ids), device=dev)
        m = gids.numel()
        for attempt in range(3):
            if need_w > chunked(w2):
                w2 = min(2 * n, max(2 * chunked(w2), 2 * need_w))
            if need_nl > nl_chunked(nl2):
                nl2 = min(2 * n, max(2 * nl2, 2 * need_nl))
            (_, maxw, ncnt, _), ms = time_once(lambda: bvh.bvh_accel_sorted(
                tree, **walk, frontier_width=w2, near_cap=nl2,
                group_ids=gids), dev)
            need_w, need_nl = int(maxw), int(ncnt)
            _emit(phase=f"escalation_{attempt + 1}", ms=ms, groups=m,
                  frontier_width=w2, near_cap=nl2, max_frontier=need_w,
                  max_near=need_nl)
            if (need_w <= chunked(w2) and need_nl <= nl_chunked(nl2)) or (
                    chunked(w2) >= 2 * n and nl2 >= 2 * n):
                break
    del tree
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bvh.HOST_READS["count"] = 0
    caps = {}
    _, ms = time_once(lambda: bvh.bvh_forces(pos, mass, cfg, theta=theta,
                                             caps_state=caps), dev)
    _emit(phase="eval", ms=ms, host_reads=bvh.HOST_READS["count"],
          peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
          caps_state=caps)


def _run_sparse(pos, mass, cfg, theta) -> None:
    from ..ops import grid_tree
    for phase in ("eval_cold", "eval"):
        _, ms = time_once(lambda: grid_tree.barnes_hut_grid(
            pos, mass, cfg, theta=theta), pos.device)
        _emit(phase=phase, ms=ms)


def _child(args) -> None:
    dev = torch.device("cuda", 0)
    bodies, cfg = _bodies(args.N, args.dim, args.plummer, args.seed, dev)
    fn = {"bvh": _run_bvh, "sparse": _run_sparse}[args.path]
    fn(bodies.positions, bodies.masses, cfg, args.theta)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.bvh_probe")
    p.add_argument("-N", type=int, default=1_000_000)
    p.add_argument("--dim", type=int, default=3, choices=(2, 3))
    p.add_argument("--plummer", action="store_true")
    p.add_argument("--theta", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=1700)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--paths", default="bvh,sparse")
    p.add_argument("--out", default=None)
    p.add_argument("--path", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bvh_probe needs a CUDA device", file=sys.stderr)
        return 1
    if args.path:
        _child(args)
        return 0
    smi = card_line(torch.device("cuda", 0))
    kind = "Plummer (G=1, softening 4/N)" if args.plummer else "uniform"
    record = {"n": args.N, "dim": args.dim, "bodies": kind,
              "theta": args.theta, "seed": args.seed, "device": smi}
    rc = 0
    for path in args.paths.split(","):
        cmd = [sys.executable, "-m", "nbody_tpu_torch.tools.bvh_probe",
               "--path", path] + (argv if argv is not None else sys.argv[1:])
        t0 = time.perf_counter()
        res = {}
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout)
            stdout = proc.stdout
            if proc.returncode:
                res.update(failed=proc.returncode,
                           stderr=proc.stderr[-2000:])
        except subprocess.TimeoutExpired as exc:
            stdout = exc.stdout or ""
            if isinstance(stdout, bytes):
                stdout = stdout.decode()
            res["cut_after_s"] = args.timeout
        for line in stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                res[rec.pop("phase")] = rec
        res["wall_s"] = time.perf_counter() - t0
        rc |= "failed" in res
        record[path] = res
        print(f"{path} N={args.N} {args.dim}D {kind} theta={args.theta}: "
              f"{json.dumps(res)}; {smi}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(record) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
