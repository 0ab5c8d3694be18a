#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nbody_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``nbody_tpu_torch/csrc`` (the brute-force
kernels K1-K5, the tree near field K6 and the rate probe P; K1 and K3 on
one Newton-3 tile engine, ``csrc/newton3_tile.cuh``; K4 as one
thread-block cluster; the ptxas report must show no spills in the engine,
K4, K6 or P's product), holds each against its
plain PyTorch version on the card, and drives the port's paths
through the public entry points, each with the launch counts set to 0 just
before it and read just after:

* the main path, ``Simulation(method="brute")`` and the benchmark CLI at
  N = 2^20 (K2, K1);
* the segmented driver at N = 2,000,000 2D (K1 on the diagonal, K3 across);
* fused small-N stepping at N = 1000 2D (K4, one cluster of 16 or 8 SMs);
* the matmul-form tile with Morton sorting at N = 262,144 2D (K5);
* the Barnes-Hut grid tier, ``Simulation(method="barnes_hut")`` and the CLI
  ``-m b`` at N = 1e6 2D and 1e5 3D (K6's tree kernel, one launch per
  evaluated segment), with its accuracy against the f64 oracle, K6 against
  the plain near field on one tree, and the phase times;
* the rate-probe tool ``nbody_tpu_torch.tools.microbench`` (P);
* the FMM tier at order 8, ``Simulation(method="fmm")`` at N = 1e6 2D, the
  CLI ``-m f`` at 1e5 3D and one evaluation at 4M 3D (K6, one launch per
  fp32 evaluation), with TF32 refused, its f64 runs against the f64 oracle,
  its fp32 runs against the f64 FMM, its near phase bit for bit against
  Barnes-Hut theta = 0.5's, and the phase times;
* the sparse grid on a clustered Plummer 1e5 3D input (Barnes-Hut and FMM
  under ``layout="auto"``, no K6 launch) against the f64 oracle, and the
  sparse Barnes-Hut layout beside the dense one at 1e6 2D.

It times every kernel against its plain version and gives each its bound
(the least time the card could take for the same work). Every check raises on
failure, so any failed phase exits non-zero. The last line is one JSON
object naming the device; the line before it is the card's name and power
limit, and the one before that lists the kernels with their launches,
errors and times.

Needs one CUDA device; exits non-zero without one. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# Scale-normalized force error allowed against the f64 plain version: the
# JAX package's own kernel-test tolerance (tests/test_pallas_brute.py).
FORCE_TOL = 1e-4
HEADLINE_N = 1 << 20
SIM_N = 262_144
TIMED_N = 262_144
SEED = 0
# The segmented driver at the size of the reference's 2e6 GPU row
# (bench/registry.py:106-108), and a ragged odd-segment 3D case.
SEG_N = 2_000_000
SEG_N3 = 300_001
# K1 and K3 against their plain versions at the edges of the engine's
# 1024-body block: N below it, N = block - 1 and block + 1, and ragged N
# over several blocks, in 2D and 3D, at softening 0 (with coincident
# bodies) and at the default.
K1_EDGE_N = [700, 1023, 1025, 3001]
K3_EDGE = [(700, 300), (1023, 1025), (1025, 1023), (2500, 3001)]
# K3 against its plain version: (targets, sources, dim, softening 0?).
SYM_TILE_PAIRS = [(100, 200, 2, False), (130, 170, 3, False),
                  (4099, 5000, 3, True), (3000, 1_000_003, 2, False)] + [
    (t, s, dim, coincident) for t, s in K3_EDGE for dim in (2, 3)
    for coincident in (False, True)]
# K4: the reference's small-N row (1000,BruteForce_CUDA,2, BASELINE.md:20)
# and the largest N the kernel takes; per-step time by differencing runs of
# K_LO and K_HI steps (tools/smalln_floor.py:106-116). FUSED_SINGLE: steps
# of one launch held bit for bit to as many one-step launches.
SMALL_N = 1000
FUSED_N = 2048
FUSED_STEPS = 64
FUSED_SINGLE = 8
K_LO, K_HI = 256, 4096
# K5: the JAX package's mxu test sizes and bounds (tests/test_pallas_brute.py
# :109, :131): (N, sort, block_t, tol), at its block_t = 64 and once at the
# default 256.
MXU_SETS = [(256, False, 64, 5e-3), (512, False, 64, 3e-4),
            (512, True, 64, 3e-4), (512, True, 256, 3e-4)]
# K5 on its path at TIMED_N, sorted, default blocks, on sampled rows: each
# body's error in fp32 ulps of the form's cancellation scale (see
# mxu_error_ulps). Per term the kernel rounds once in the product and up to
# kChain - 1 = 31 times in its fp32 chain, with rsqrtf's 2 ulp besides.
MXU_ULPS = 64
SAMPLED_ROWS = 2048
# K6's fp32 floor (see fp32_floor). Where one near pair makes a body's
# force hundreds of times the RMS, that pair's fp32 term sets the body's
# error. Its relative error, worst case, in fp32 ulps: d² = Σ Δ² + ε² about
# 3 (Δ rounded once, squares and adds); u = rsqrtf(d²) 2 + 3/2 = 3.5; u·u·u
# 3 × 3.5 + 1 = 11.5; times Δ and m about 1.5: 13 in all. Rounding errors
# rarely line up, so the reading is far below that: 4.04 on the 1e5 3D near
# field on the card, which failed the 4 ulps K3 is held to. K6 is held to 8,
# about twice that reading and under the worst case.
K6_ULPS = 8
# K6's tree kernel on the near field's edge cases: bodies in [0, 1]^D at
# the leaf level barnes_hut_grid picks for theta = 0.25 (N, dim).
K6_EDGE = [(200_000, 2), (100_000, 3)]
# The Barnes-Hut grid tier at the reference's own rows (BASELINE.md:29-32,
# uniform random_system): Simulation and CLI sizes, leapfrog steps, and the
# timed force evaluations (N, dim, theta); K6's own line is timed at the
# first of them.
BH_SIM = [(1_000_000, 2), (100_000, 3)]
BH_STEPS = 2
BH_CLI = [(1_000_000, 2, False), (100_000, 3, True)]
BH_TIMED = [(1_000_000, 2, 0.25), (1_000_000, 2, 0.5), (100_000, 3, 0.25),
            (5_000_000, 2, 0.25)]
BH_K6_TIMED = "1000000_2d_theta0.25"
# The Barnes-Hut accuracy inputs (Simulation and theta sweeps of BH_SIM):
# bodies drawn from BH_SEED, BH_ROWS sampled rows from BH_SEED + 1, as
# crosscheck/bh_reference_metric.py draws them.
BH_SEED = 1200
BH_ROWS = 4096
# The reference metric (% of bodies with every component within 1%) at
# theta = 0.25. Over every body against K1: the JAX tests' 99% in 3D
# (tests/test_local_expansion.py:337-352). On the sampled rows against the
# f64 oracle, in 2D and 3D: at least the JAX package's own reading on the
# same bodies and rows (crosscheck/bh_reference_metric.py, JAX on the CPU),
# less 4 of the 4096 rows. Both packages evaluate the same tree in fp32 and
# differ only in summation order, so only a body within ~1e-6 of the 1%
# edge can read otherwise.
BH_ACCURACY_3D = 99.0
BH_JAX_ROWS_PCT = {(1_000_000, 2): 99.0478515625, (100_000, 3): 99.462890625}
BH_ROWS_SLACK = 4 * 100.0 / BH_ROWS
# The FMM tier at the reference's FMM rows (BASELINE.md:43-50, uniform
# random_system) and its "FMM p=8 full pipeline, N=4M" configuration
# (BASELINE.md:72), order FMM_ORDER = 8 (config.py): Simulation (1 leapfrog
# step) and the CLI -m f; one evaluation at 4M 3D; f64 runs held to the JAX
# package's order-8 gate against the f64 oracle (tests/test_fmm.py:85-93);
# timed shapes (N, dim) beside the reference's CPU seconds.
FMM_SIM = (1_000_000, 2)
FMM_CLI = (100_000, 3)
FMM_BIG = (4_000_000, 3)
FMM_SEED = 1400
FMM_GATE = 1e-4
FMM_TIMED = [(100_000, 2), (100_000, 3), (1_000_000, 2), FMM_BIG]
FMM_REFERENCE_S = {
    (100_000, 2): "FMM_Sequential 0.555 s",
    (100_000, 3): "FMM_Sequential 1.851 s, FMM_OpenMP 0.409 s",
    (1_000_000, 2): "FMM_Sequential 12.25 s",
    FMM_BIG: "no time: the 'FMM p=8 full pipeline, N=4M' target",
}
# The fp32 FMM against the f64 FMM on the same tree: the near field's K6
# floor (K6_ULPS, see fp32_floor) plus the far field's. L2P takes the
# gradient of the interpolated potential: per body it sums n^D terms
# |dS_m| * |w_m| / (h/2) whose size can be ~1e4 times the far force (the
# potential of every V-list cell, nearly constant across a leaf, cancels),
# so fp32 errors of the local weights w and of that sum come out at a few
# ulps of the term sum, not of the force. Worst case, in fp32 ulps of the
# term sum: the T_k recurrence to k = 7 about 7, the basis products 3, the
# M2L / L2L sums of 316 x 512 terms up to 17 (pairwise), the L2P sum of 512
# terms 9: about 36. On the CPU (fp32 against f64, same tree, uniform
# bodies at 1e5 2D L5, 2e4 3D L2-L3 and 1e5 3D L3;
# crosscheck/fmm_fp32_floor.py) the largest body read 1.9-6.1. Each body's far field is held to 32 ulps of its own term sum,
# and what exceeds that to the near field's K6 floor.
FMM_FAR_ULPS = 32
# The sparse grid on the clustered input the dense grid refuses: Plummer
# 1e5 3D in Henon units (G = 1, softening 4/N, models/scenarios.py:27-33 of
# the JAX package), the shape of its artifacts/clustered_stress.json.
# Against the f64 oracle on sampled rows: Barnes-Hut theta = 0.25 within
# 1e-3 (section 2 of PERF.md), FMM within FMM_GATE.
SPARSE_N = 100_000
SPARSE_SEED = 1500
SPARSE_BH_TOL = 1e-3
SPARSE_UNIFORM = (1_000_000, 2)
# The rate probe P: iterations of its plain-version check at the tool's
# block, the tool's run, and the f32 FMA launch of the kernels line, timed
# and held beside its plain version.
PROBE_ITERS_SMALL = 5
PROBE_ITERS = 1 << 20
PROBE_ITERS_TIMED = 16384
# P's product against its f64 plain version, scale-normalized, at the
# tool's 64 repeats of U(0, 1) inputs. An output of the wide kernel is an
# fp32 chain of 64 repeats x 32 k of one k-group, then 8 + 8 adds; round-
# to-nearest errors of a growing chain of n positive terms come to about
# sqrt(n / 3) * 2^-24 of the sum, 1.6e-6 at n = 2048 (the worst case,
# n * 2^-24, is 1.2e-4). The narrow kernel's chains are 512 long. 2e-5 is
# twelve times the expected reading.
MATMUL_TOL = 2e-5
# P's product off the tool's shapes: ragged M, S and K for both kernels.
MATMUL_RAGGED = [(37, 2500, 7), (37, 2500, 150)]
# Published H100 SXM peaks (NVIDIA's data sheet, dense): fp32 outside the
# tensor cores, HBM3. The MUFU rsqrt rate is 16 lanes/clk on each of 132
# SMs at the 1.98 GHz boost clock (Hopper white paper).
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
MUFU_RATE = 132 * 16 * 1.98e9


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check_close(name, got, want, tol=FORCE_TOL) -> float:
    """Raise unless ``got`` is finite and within ``tol`` (scale-normalized)
    of ``want``; return the max abs error."""
    from nbody_tpu_torch.utils.accuracy import scale_normalized_error
    got64 = got.to(torch.float64)
    finite = bool(torch.isfinite(got).all())
    err = float(scale_normalized_error(got64, want))
    max_abs = float((got64 - want).abs().max())
    print(f"  {name}: scale-normalized err {err:.3e} (tol {tol:g}), "
          f"max abs err {max_abs:.3e}, finite {finite}")
    if not (finite and err < tol):
        raise AssertionError(f"{name}: err {err} (tol {tol}), finite {finite}")
    return max_abs


def counts() -> dict:
    """Every kernel's launch count (its wrapper adds one per launch)."""
    from nbody_tpu_torch.utils.cuda_build import LAUNCHES
    return LAUNCHES


def reset_launches() -> None:
    for k in counts():
        counts()[k] = 0


def expect_launches(what, launches, want) -> None:
    """Raise unless the counts of ``want``'s kernels are exactly ``want``."""
    have = {k: launches[k] for k in want}
    print(f"    {what} launches: {have}")
    if have != want:
        raise AssertionError(f"{what}: launches {have} != {want}")


def time_ms(fn, reps: int = 3, launches: int = 1) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after 1 warm-up.
    With ``launches`` > 1 a run calls ``fn`` that many times back to back
    and the time is one call's share: the card then stays busy while the
    host enqueues the next call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def coincident_set(n, gen, dev):
    """softening=0 inputs with coincident bodies (the guard must hold):
    rows 0 and 1, and rows 3 and n - 2, which lie in different 1024-body
    blocks once n > 1028."""
    pos = torch.empty((n, 3), dtype=torch.float64)
    pos[:2] = torch.tensor([1.0, 1.0, 1.0])
    pos[2] = torch.tensor([5.0, 1.0, 1.0])
    pos[3:] = 10.0 + 10.0 * torch.rand((n - 3, 3), generator=gen,
                                       dtype=torch.float64)
    if n > 5:
        pos[n - 2] = pos[3]
    return pos.to(dev, torch.float32), torch.ones(n, device=dev)


def oracle64(cb, pos, mass, cfg, rows=None):
    """f64 one-sided plain forces (optionally on sampled rows)."""
    pos64, m64 = pos.double(), mass.double()
    tgt = pos64 if rows is None else pos64[rows]
    tm = m64 if rows is None else m64[rows]
    return (cfg.G * tm)[:, None] * cb.pairwise_accel_plain(
        tgt, pos64, m64, cfg.softening)


def fp32_floor(want, ulps: int = 4) -> float:
    """Scale-normalized error of ``ulps`` fp32 ulps on the largest body's
    own force. One pair's term carries about that much in fp32 (rsqrtf's
    2 ulp, the u·u·u and mass products), so no fp32 sum can read less
    where one body's force is hundreds of times the RMS. That happens on
    the source side of a thin rectangle: each of 1,000,003 sources sees
    only 3000 targets, and the nearest of them decides its force."""
    f = want.norm(dim=-1)
    return ulps * 2.0 ** -24 * float(f.max() / f.pow(2).mean().sqrt())


def seeded(phase: int) -> torch.Generator:
    return torch.Generator().manual_seed(SEED + phase)


def sample_rows(n, gen, dev):
    return torch.randperm(n, generator=gen)[:SAMPLED_ROWS].to(dev)


def phase_sym_tile(cb, gen, dev, default) -> dict:
    """[8] K3 against its plain version; the segmented driver, counted."""
    from nbody_tpu_torch.state import random_system
    print("[8] K3 sym tile vs f64 plain version (both outputs)")
    errs = []
    for t, s, dim, coincident in SYM_TILE_PAIRS:
        if coincident:
            p, m = coincident_set(t + s, gen, dev)
            p = p[:, :dim].contiguous()
            # Rows 0 and 1 coincide: row 1 is a target, row 0 a source.
            tp, tm = p[1:t + 1], m[1:t + 1]
            sp = torch.cat([p[:1], p[t + 1:]])
            sm = torch.cat([m[:1], m[t + 1:]])
            soft, label = 0.0, f"{t}x{s} {dim}D softening=0 coincident"
        else:
            bodies = random_system(t + s, dim, generator=gen, device=dev)
            tp, sp = bodies.positions[:t], bodies.positions[t:]
            tm, sm = bodies.masses[:t], bodies.masses[t:]
            soft, label = default.softening, f"{t}x{s} {dim}D"
        got = cb.sym_tile_cuda(tp, tm, sp, sm, soft)
        want = cb.sym_tile_plain(tp.double(), tm.double(), sp.double(),
                                 sm.double(), soft)
        for side, g, w in zip(("acc_t", "part_s"), got, want):
            errs.append(check_close(f"{label} {side}", g, w,
                                    tol=max(FORCE_TOL, fp32_floor(w))))
    bodies = random_system(300, 3, generator=gen, device=dev)
    p, m = bodies.positions, bodies.masses
    got = cb.sym_tile_cuda(p[:100], m[:100], p[100:], m[100:],
                           default.softening, chunk=64)
    want = cb.sym_tile_plain(p[:100].double(), m[:100].double(),
                             p[100:].double(), m[100:].double(),
                             default.softening)
    for side, g, w in zip(("acc_t", "part_s"), got, want):
        check_close(f"100x200 3D chunk=64 (2 x 4 launches) {side}", g, w)

    print(f"    brute_force_cuda_segmented, N={SEG_N} 2D, default segments")
    big = random_system(SEG_N, 2, generator=gen, device=dev)
    reset_launches()
    got = cb.brute_force_cuda_segmented(big.positions, big.masses, default)
    torch.cuda.synchronize()
    launches = dict(counts())
    expect_launches(f"segmented N={SEG_N} 2D", launches,
                    {"symmetric": 2, "sym_tile": 1})
    rows = sample_rows(SEG_N, gen, dev)
    seg_err = check_close(
        f"segmented N={SEG_N} 2D, {SAMPLED_ROWS} sampled rows vs one-sided "
        "f64 sum", got[rows], oracle64(cb, big.positions, big.masses,
                                       default, rows))
    del got, big
    print(f"    brute_force_cuda_segmented, N={SEG_N3} 3D, num_segments=3")
    b3 = random_system(SEG_N3, 3, generator=gen, device=dev)
    reset_launches()
    got = cb.brute_force_cuda_segmented(b3.positions, b3.masses, default,
                                        num_segments=3)
    expect_launches(f"segmented N={SEG_N3} 3D", counts(),
                    {"symmetric": 3, "sym_tile": 3})
    rows = sample_rows(SEG_N3, gen, dev)
    check_close(f"segmented N={SEG_N3} 3D, {SAMPLED_ROWS} sampled rows",
                got[rows], oracle64(cb, b3.positions, b3.masses, default,
                                    rows))
    return {"launches": launches["sym_tile"], "max_abs_err": max(errs),
            "segmented_max_abs_err": seg_err}


def check_states(label, have, want, v_tol=FORCE_TOL, x_tol=1e-5) -> float:
    """Velocities within ``v_tol`` scale-normalized, positions within
    ``x_tol`` of the largest coordinate; returns the velocities' max abs
    error."""
    (x, v), (x_ref, v_ref) = have, want
    err = check_close(f"{label} velocities", v, v_ref.double(), tol=v_tol)
    x_err = float((x - x_ref).abs().max() / x_ref.abs().max())
    print(f"  {label} positions: max abs diff / max |x| = {x_err:.3e} "
          f"(tol {x_tol:g})")
    if not x_err < x_tol:
        raise AssertionError(f"{label}: positions differ by {x_err}")
    return err


def fused_checks(cb, systems, kw, cluster):
    """K4 at the cluster size in use against its plain version on each
    system and integrator, with two runs and K steps against K one-step
    launches held bit for bit. Returns the errors and the states."""
    errs, states = [], {}
    for s in systems:
        n, dim = s.positions.shape
        label = f"C={cluster} N={n} {dim}D"
        state = (s.positions, s.velocities, s.masses)
        for integ in ("euler", "leapfrog"):
            run = dict(kw, integrator=integ, num_steps=FUSED_STEPS)
            got = cb.fused_smalln_simulate(*state, **run)
            states[(n, integ)] = got
            errs.append(check_states(f"{label} {integ}", got,
                                     cb.fused_smalln_plain(*state, **run)))
            again = cb.fused_smalln_simulate(*state, **run)
            whole = cb.fused_smalln_simulate(
                *state, **dict(run, num_steps=FUSED_SINGLE))
            x, v = state[0], state[1]
            for _ in range(FUSED_SINGLE):
                x, v = cb.fused_smalln_simulate(
                    x, v, state[2], **dict(run, num_steps=1))
            same = all(map(torch.equal, got, again))
            split = all(map(torch.equal, whole, (x, v)))
            print(f"  {label} {integ}: two runs identical {same}; "
                  f"{FUSED_SINGLE} steps in one launch identical to "
                  f"{FUSED_SINGLE} one-step launches {split}")
            if not (same and split):
                raise AssertionError(f"K4 {label} {integ}: runs identical "
                                     f"{same}, steps identical {split}")
    return errs, states


def phase_fused(cb, gen, dev) -> dict:
    """[9] K4 against its plain version on the card, counted; its runs
    bit-identical, and K steps in one launch bit-identical to K launches of
    one step (for leapfrog that holds the force K4 carries from a step into
    the next to the force a new launch computes)."""
    from nbody_tpu_torch import GravityConfig
    from nbody_tpu_torch.state import plummer_system, random_system
    unit = GravityConfig(G=1.0, softening=0.1)
    kw = {"g": unit.G, "softening": unit.softening, "dt": 1e-3}
    # Both sides run the same fp32 operations per step and differ only in
    # the order of each force sum (~1e-6 of the RMS force). 64 steps of
    # dt 1e-3 (t = 0.064, far below the crossing time of these clusters)
    # add those differences up without amplifying them, so velocities stay
    # well inside FORCE_TOL and positions, which move by ~1e-2, inside
    # 1e-5 of the largest coordinate.
    cluster = cb.fused_cluster_size()
    print(f"[9] K4 fused small-N stepping vs its plain version on the card, "
          f"G=1, softening=0.1, dt=1e-3, {FUSED_STEPS} steps; one cluster "
          f"of C={cluster} CTAs")
    small = plummer_system(SMALL_N, 2, generator=gen, device=dev)
    big = plummer_system(FUSED_N, 3, generator=gen, device=dev)
    reset_launches()
    cb.fused_smalln_simulate(small.positions, small.velocities, small.masses,
                             integrator="leapfrog", num_steps=FUSED_STEPS,
                             **kw)
    torch.cuda.synchronize()
    launches = dict(counts())
    expect_launches(f"fused_smalln_simulate N={SMALL_N} 2D leapfrog",
                    launches, {"fused_steps": 1})
    errs, states = fused_checks(cb, (small, big), kw, cluster)
    # The portable size, once, through the same wrapper: the cluster that a
    # card placing no cluster of 16 takes (R = 2 at N = 2048). It adds the
    # same chains in other groups, so its bits may differ from C = 16's.
    if cluster == 16:
        cb.set_fused_cluster_size(8)
        try:
            if cb.fused_cluster_size() != 8:
                raise AssertionError("K4: C=8 was not taken")
            more, portable = fused_checks(cb, (small, big), kw, 8)
        finally:
            cb.set_fused_cluster_size(0)
        errs += more
        same = all(torch.equal(a, b) for key in states
                   for a, b in zip(states[key], portable[key]))
        print(f"  C=8 states identical to C=16's: {same}")
    # Reference units, as tests/test_pallas_brute.py:216-223: nothing moves
    # at fp32 resolution, so both sides must agree to the last bit.
    ref = random_system(300, 2, generator=gen, device=dev)
    cfg = GravityConfig()
    for integ in ("euler", "leapfrog"):
        args = ((ref.positions, ref.velocities, ref.masses),
                {"dt": 1e-6, "num_steps": 8, "g": cfg.G,
                 "softening": cfg.softening, "integrator": integ})
        got = cb.fused_smalln_simulate(*args[0], **args[1])
        want = cb.fused_smalln_plain(*args[0], **args[1])
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"  N=300 2D reference units {integ}: identical {same}")
        if not same:
            raise AssertionError(f"reference-units {integ} states differ")
    return {"launches": launches["fused_steps"], "max_abs_err": max(errs),
            "cluster": cluster}


def phase_mxu(cb, gen, dev, default) -> dict:
    """[10] K5 against the f64 sum and its plain version, counted."""
    from nbody_tpu_torch.ops.keys import morton_key
    from nbody_tpu_torch.state import random_system
    print("[10] K5 mxu tile vs f64 one-sided sum and vs its plain version "
          "on the same blocks (fp32, TF32 off)")
    errs = []
    for n, sort, block_t, tol in MXU_SETS:
        bodies = random_system(n, 3, generator=gen, device=dev)
        p, m = bodies.positions, bodies.masses
        label = f"N={n} 3D sort={sort} block_t={block_t}"
        got = cb.brute_force_cuda(p, m, default, mode="mxu", sort=sort,
                                  block_t=block_t)
        errs.append(check_close(label, got, oracle64(cb, p, m, default),
                                tol=tol))
        if sort:
            order = torch.argsort(morton_key(p), stable=True)
            p, m = p[order], m[order]
        # The plain version in f64 on the same blocks: in fp32 it carries
        # the form's own cancellation error, several times the kernel's,
        # whose sums and correction run in fp64.
        check_close(f"{label} kernel vs mxu_accel_plain (f64, same blocks)",
                    cb.pairwise_accel_cuda(p, p, m, default.softening,
                                           mode="mxu", block_t=block_t),
                    cb.mxu_accel_plain(p.double(), p.double(), m.double(),
                                       default.softening, block_t), tol=tol)
    bodies = random_system(TIMED_N, 2, generator=gen, device=dev)
    p, m = bodies.positions, bodies.masses
    reset_launches()
    got = cb.brute_force_cuda(p, m, default, mode="mxu", sort=True)
    torch.cuda.synchronize()
    launches = dict(counts())
    expect_launches(f"brute_force_cuda(mode='mxu', sort=True) N={TIMED_N} "
                    "2D", launches, {"mxu": 1})
    rows = sample_rows(TIMED_N, gen, dev)
    ulps = mxu_error_ulps(cb, p, m, default, rows, got)
    print(f"  N={TIMED_N} 2D sorted, {SAMPLED_ROWS} sampled rows: max error "
          f"{ulps:.2f} fp32 ulps of the cancellation scale (tol {MXU_ULPS}),"
          f" finite {bool(torch.isfinite(got).all())}")
    if not (bool(torch.isfinite(got).all()) and ulps < MXU_ULPS):
        raise AssertionError(f"K5 at N={TIMED_N}: {ulps} ulps")
    return {"launches": launches["mxu"], "max_abs_err": max(errs)}


def mxu_error_ulps(cb, pos, mass, cfg, rows, got, block_t=256) -> float:
    """K5's largest error on ``rows``, in fp32 ulps of each body's
    cancellation scale, against the f64 one-sided sum.

    The form returns a[:D] - (x_t - c)·a[D], a[D] = Σ_s m_s·u³: both terms
    are of size |x_t - c|·a[D] and cancel down to the acceleration, so fp32
    rounds at that scale and not at the force's (pallas_brute.py:283-289).
    How far they cancel depends on the draw: the scale-normalized error of
    the same run read 1.7e-3 and 5.0e-3 on two draws of this shape (my
    chip runs), where the f32 plain version reads ~1e-1 unsorted. The scale
    is the larger of |x_t - c|·a[D] and |a|; the bodies are in the
    wrapper's Morton order and c is the first of each block of
    ``block_t``."""
    from nbody_tpu_torch.ops.brute_force import _diffs_d2, _guarded_u3
    from nbody_tpu_torch.ops.keys import morton_key
    from nbody_tpu_torch.utils.accuracy import scale_normalized_error
    order = torch.argsort(morton_key(pos), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    c = pos[order[rank[rows] // block_t * block_t]].double()
    tgt, p64, m64 = pos[rows].double(), pos.double(), mass.double()
    want = cb.pairwise_accel_plain(tgt, p64, m64, cfg.softening, guard=True)
    a_d = torch.cat([
        (_guarded_u3(_diffs_d2(tgt[r:r + 256], p64)[1], cfg.softening)
         * m64).sum(dim=1) for r in range(0, tgt.shape[0], 256)])
    scale = torch.maximum((tgt - c).norm(dim=1) * a_d, want.norm(dim=1))
    have = got[rows].double() / (cfg.G * m64[rows])[:, None]
    print(f"  (scale-normalized err {float(scale_normalized_error(have, want)):.3e}"
          ", not held: it depends on how far the draw cancels)")
    return float(((have - want).norm(dim=1) / scale).max()) / 2.0 ** -24


def bh_tree(gt, pos, mass, theta):
    """barnes_hut_grid's own static choices and tree for (pos, θ)."""
    n, dim = pos.shape
    rp = gt.resolve_bh_params(n, dim, theta)
    cap = gt.compute_capacity(pos, rp["leaf_level"])
    tree = gt.build_grid_tree(pos, mass, rp["leaf_level"], cap, quad=True)
    return rp, tree


def k6_calls(gt, tree, k):
    """The window entry's inputs for the first leaf batch, as the plain
    near field forms them: [(targets, sources)], one per child parity in
    the parent-shared layout."""
    lb, _ = gt.near_batch_plan(tree, k)
    ids = torch.arange(lb, device=tree.pos_sorted.device)
    tb, _, _ = gt._window_rows(tree, ids)
    return gt.near_field_inputs(tree, k, ids, tb)[0]


def tree_f64(gt, tree):
    """The same tree with every floating field in f64."""
    def f64(v):
        if isinstance(v, tuple):
            return tuple(f64(x) for x in v)
        return v.double() if torch.is_tensor(v) and v.is_floating_point() \
            else v
    return dataclasses.replace(tree, **{
        f.name: f64(getattr(tree, f.name))
        for f in dataclasses.fields(tree)})


def unit_tree(gt, n, dim, gen, dev):
    """A tree over n bodies in [0, 1]^D at the leaf level barnes_hut_grid
    picks for theta = 0.25, for the near field's edge cases: 99 coincident
    twins (one leaf each), 100 twins 2e-6 apart astride a cell boundary
    (raw d² < 1e-10 in neighbouring leaves), every fifth mass 0. Returns
    (k, tree, twins astride two leaves)."""
    rp = gt.resolve_bh_params(n, dim, 0.25)
    L = rp["leaf_level"]
    pos = torch.rand((n, dim), generator=gen, dtype=torch.float64)
    pos[0], pos[1] = 0.0, 1.0  # the bounds stay [0, 1]
    pos[2:200:2] = pos[3:200:2]
    a = torch.arange(200, 400, 2)
    edge = -0.005 + 1.01 / (1 << L) * torch.randint(
        1, (1 << L) - 1, (a.numel(),), generator=gen).double()
    pos[a, 0], pos[a + 1, 0] = edge - 1e-6, edge + 1e-6
    pos[a + 1, 1:] = pos[a, 1:]
    mass = 0.5 + torch.rand(n, generator=gen, dtype=torch.float64)
    mass[::5] = 0.0
    p32, m32 = pos.float().to(dev), mass.float().to(dev)
    tree = gt.build_grid_tree(p32, m32, L, gt.compute_capacity(p32, L))
    leaf = torch.empty_like(tree.leaf_ids)
    leaf[tree.order] = tree.leaf_ids
    astride = int((leaf[a.to(dev)] != leaf[a.to(dev) + 1]).sum())
    return rp["k"], tree, astride


def phase_p2p(gen, dev, default) -> dict:
    """[11] K6 against its f64 plain version on the card: the window entry
    in the JAX kernel's layout, then the path's tree kernel."""
    from nbody_tpu_torch.ops import cuda_p2p, grid_tree as gt
    from nbody_tpu_torch.state import random_system
    print(f"[11] K6 vs f64 plain version (tol: max(1e-5, {K6_ULPS} fp32 ulps "
          f"of the largest force / RMS)); the window entry p2p_leaf first")
    sets = []
    # Coincident pairs (each target's twin among the sources) and
    # zero-mass sources, at softening 0 and at the default.
    for b, c, s, dim in ((16, 48, 3072, 2), (8, 56, 4000, 3)):
        t = 1e7 * torch.rand((b, c, dim), generator=gen, dtype=torch.float64)
        src = torch.zeros((b, s, 4), dtype=torch.float64)
        src[..., :dim] = 1e7 * torch.rand((b, s, dim), generator=gen,
                                          dtype=torch.float64)
        src[:, :c, :dim] = t
        src[..., 3] = 1e8 * torch.rand((b, s), generator=gen,
                                       dtype=torch.float64)
        src[:, ::5, 3] = 0.0
        for soft in (0.0, default.softening):
            sets.append((f"{b}x{c}x{s} {dim}D coincident + zero-mass, "
                         f"softening={soft:g}", t.float().to(dev),
                         src.float().to(dev), soft))
    # The JAX test's shape (N = 500 3D, θ = 0.5) and the path's windows.
    trees = {}
    for n, dim, theta in ((500, 3, 0.5), (1_000_000, 2, 0.25),
                          (1_000_000, 2, 0.5), (100_000, 3, 0.25),
                          (100_000, 3, 0.5)):
        bodies = random_system(n, dim, generator=gen, device=dev)
        rp, tree = bh_tree(gt, bodies.positions, bodies.masses, theta)
        trees[(n, dim, theta)] = (rp, tree)
        calls = k6_calls(gt, tree, rp["k"])
        layout = "parent-shared" if len(calls) > 1 else "k=1 neighbours"
        t, s = calls[0]
        sets.append((f"window N={n} {dim}D theta={theta} ({layout}) "
                     f"{tuple(t.shape)} x {tuple(s.shape)}", t, s,
                     default.softening))
    errs = []
    for label, t, s, soft in sets:
        got = cuda_p2p.p2p_leaf_cuda(t, s, softening=soft)
        want = cuda_p2p.p2p_plain(t.double(), s.double(), soft)
        dim = t.shape[-1]
        w = want.reshape(-1, dim)
        errs.append(check_close(label, got.reshape(-1, dim), w,
                                tol=max(1e-5, fp32_floor(w, K6_ULPS))))

    def tree_case(label, tree, k, soft, segments=1):
        nl = tree.num_leaf_cells // segments
        got = sum(cuda_p2p.near_field_cuda(tree, k, soft, si * nl, nl)
                  for si in range(segments))
        if not torch.equal(got, sum(
                cuda_p2p.near_field_cuda(tree, k, soft, si * nl, nl)
                for si in range(segments))):
            raise AssertionError(f"{label}: two launches differ")
        want = cuda_p2p.near_field_plain(tree_f64(gt, tree), k, soft)
        errs.append(check_close(
            f"{label}, {cuda_p2p.near_field_pairs(tree, k)} real pairs", got,
            want, tol=max(1e-5, fp32_floor(want, K6_ULPS))))

    print("    the tree kernel near_field vs the f64 plain near field")
    for n, dim in K6_EDGE:
        k, tree, astride = unit_tree(gt, n, dim, gen, dev)
        print(f"    N={n} {dim}D in [0, 1]^{dim}, L={tree.leaf_level}, k={k}, "
              f"capacity {tree.capacity}: {astride} of 100 close twins in "
              "two leaves")
        if astride < 90:
            raise AssertionError(f"only {astride} twins astride two leaves")
        for soft in (0.0, default.softening):
            tree_case(f"N={n} {dim}D twins, zero masses, softening={soft:g}",
                      tree, k, soft)
    rp, tree = trees[(1_000_000, 2, 0.5)]
    tree_case(f"N=1e6 2D theta=0.5 (capacity {tree.capacity}: leaves of up "
              "to 10 target chunks)", tree, rp["k"], default.softening)
    rp, tree = trees[(100_000, 3, 0.25)]
    tree_case("N=1e5 3D theta=0.25 in 4 segments (4 launches)", tree,
              rp["k"], default.softening, segments=4)
    return {"max_abs_err": max(errs)}


def phase_bh(cb, gen, dev, default, smi) -> dict:
    """[12] The Barnes-Hut grid tier on the card (path A), K6 counted: one
    launch of its tree kernel per evaluated segment."""
    from nbody_tpu_torch import Simulation, cli
    from nbody_tpu_torch.ops import cuda_p2p, grid_tree as gt
    from nbody_tpu_torch.ops.hier_far import hier_far_coeffs
    from nbody_tpu_torch.state import random_system
    from nbody_tpu_torch.utils.accuracy import (accuracy_percentage,
                                                scale_normalized_error)
    out = {"launches": 0}

    def bh_accuracy(label, got, pos, mass, rows, theta, tol):
        """The reference metric over every body against K1, as the CLI
        reckons it, and on ``rows`` against the f64 oracle, with the
        scale-normalized error there (held to ``tol``). At the default
        theta the metric is held as BH_ACCURACY_3D and BH_JAX_ROWS_PCT
        say."""
        ref = cb.brute_force_cuda(pos, mass, default, mode="symmetric")
        pct = float(accuracy_percentage(got, ref))
        want = oracle64(cb, pos, mass, default, rows)
        pct_rows = float(accuracy_percentage(got[rows].double(), want))
        print(f"  {label}: accuracy {pct:.4f}% of {pos.shape[0]} bodies vs "
              f"K1, {pct_rows:.4f}% of {rows.numel()} sampled rows vs the f64"
              " oracle")
        check_close(f"{label}, {rows.numel()} sampled rows vs f64 oracle",
                    got[rows], want, tol=tol)
        if theta != default.theta:
            return
        n, dim = pos.shape
        if dim == 3 and pct < BH_ACCURACY_3D:
            raise AssertionError(f"{label}: accuracy {pct}% < "
                                 f"{BH_ACCURACY_3D}%")
        jax_pct = BH_JAX_ROWS_PCT[(n, dim)]
        print(f"    the JAX package on the same bodies and rows: {jax_pct}% "
              f"(crosscheck/bh_reference_metric.py); port held to >= "
              f"{jax_pct - BH_ROWS_SLACK:.4f}%")
        if pct_rows < jax_pct - BH_ROWS_SLACK:
            raise AssertionError(f"{label}: {pct_rows}% on the sampled rows "
                                 f"< the JAX package's {jax_pct}% - "
                                 f"{BH_ROWS_SLACK}")

    print("[12] Barnes-Hut grid tier: Simulation, CLI -m b, K6 vs plain, "
          "f64 'auto'")
    for n, dim in BH_SIM:
        bodies = random_system(
            n, dim, generator=torch.Generator().manual_seed(BH_SEED),
            device=dev)
        rows = torch.randperm(n, generator=torch.Generator().manual_seed(
            BH_SEED + 1))[:BH_ROWS].to(dev)
        rp = gt.resolve_bh_params(n, dim, default.theta)
        want = 2 * BH_STEPS * rp["num_segments"]
        sim = Simulation.create(bodies, default, method="barnes_hut")
        print(f"    Simulation('barnes_hut').run(steps={BH_STEPS}), N={n} "
              f"{dim}D, theta={default.theta} ({rp})")
        reset_launches()
        t0 = time.perf_counter()
        sim = sim.run(steps=BH_STEPS, dt=1e-3)
        torch.cuda.synchronize()
        launches = dict(counts())
        print(f"    ran in {time.perf_counter() - t0:.2f} s")
        expect_launches(f"Simulation N={n} {dim}D", launches,
                        {"near_field": want, "p2p_leaf": 0})
        out["launches"] += launches["near_field"]
        if not (bool(torch.isfinite(sim.system.positions).all())
                and sim.step_count == BH_STEPS):
            raise AssertionError("Simulation('barnes_hut') state not finite")
        for theta, tol in ((default.theta, 1e-3), (0.5, 4e-2)):
            got = gt.barnes_hut_grid(bodies.positions, bodies.masses,
                                     default, theta=theta)
            bh_accuracy(f"N={n} {dim}D theta={theta}", got,
                        bodies.positions, bodies.masses, rows, theta, tol)

    for n, dim, acc in BH_CLI:
        args = ["-d", str(dim), "-N", str(n), "-m", "b", "--no-files",
                "--device", "cuda"] + (["-a", "1"] if acc else [])
        print(f"    CLI: {' '.join(args)}")
        # The launches it must make: each method one warm-up and one timed
        # evaluation, each one launch per segment.
        want = sum(2 * gt.resolve_bh_params(n, dim, theta)["num_segments"]
                   for theta in (default.theta, 0.5))
        buf = io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        torch.cuda.synchronize()
        launches = dict(counts())
        print(buf.getvalue(), end="")
        if rc != 0:
            raise AssertionError(f"CLI rc {rc}")
        expect_launches(f"CLI -m b N={n} {dim}D", launches,
                        {"near_field": want, "p2p_leaf": 0})
        out["launches"] += launches["near_field"]
        if acc:
            for name, tol in (("BarnesHut_Grid", 1e-3),
                              ("BarnesHut_Grid_Theta05", 4e-2)):
                m = re.search(rf"{name} accuracy: ([0-9.]+)% \(norm err "
                              r"([0-9.e+-]+)", buf.getvalue())
                ok = m is not None and float(m.group(2)) < tol and (
                    tol > 1e-2 or float(m.group(1)) >= BH_ACCURACY_3D)
                print(f"    {name} vs BruteForce_CUDA: "
                      f"{m.groups() if m else None} (norm err tol {tol:g})")
                if not ok:
                    raise AssertionError(f"CLI accuracy {name}: {m}")

    print("    K6 vs plain near field on one tree (theta=0.25)")
    for n, dim in BH_SIM:
        bodies = random_system(n, dim, generator=gen, device=dev)
        rp, tree = bh_tree(gt, bodies.positions, bodies.masses,
                           default.theta)
        kw = dict(k=rp["k"], softening=default.softening, multipole="quad",
                  far_impl=rp["far_impl"])
        near = gt.grid_tree_accel_sorted(tree, p2p_impl="cuda",
                                         _debug_skip="far", **kw)
        t64 = tree_f64(gt, tree)
        near64 = gt.grid_tree_accel_sorted(t64, p2p_impl="plain",
                                           _debug_skip="far", **kw)
        check_close(f"N={n} {dim}D near field, K6 (fp32) vs plain (f64)",
                    near, near64, tol=max(1e-5, fp32_floor(near64, K6_ULPS)))
        full = gt.grid_tree_accel_sorted(tree, p2p_impl="cuda", **kw)
        plain = gt.grid_tree_accel_sorted(tree, p2p_impl="plain", **kw)
        check_close(f"N={n} {dim}D whole evaluation, K6 vs plain (both "
                    "fp32; tol 2 fp32 floors)", full, plain.double(),
                    tol=max(1e-5, 2 * fp32_floor(plain.double(), K6_ULPS)))
        del t64, near64, full, plain

    # p2p_impl="auto" (the default) on f64 bodies: the plain near field in
    # f64, as the JAX package's "auto", and no K6 launch.
    n, dim = BH_SIM[-1]
    bodies = random_system(n, dim, generator=gen, device=dev)
    pos64, mass64 = bodies.positions.double(), bodies.masses.double()
    reset_launches()
    auto = gt.barnes_hut_grid(pos64, mass64, default)
    torch.cuda.synchronize()
    expect_launches(f"barnes_hut_grid N={n} {dim}D f64, p2p_impl='auto'",
                    counts(), {"near_field": 0, "p2p_leaf": 0})
    plain = gt.barnes_hut_grid(pos64, mass64, default, p2p_impl="plain")
    err = float(scale_normalized_error(auto, plain))
    print(f"  N={n} {dim}D f64 'auto' vs 'plain': dtype {auto.dtype}, "
          f"scale-normalized err {err:.3e} (tol 1e-12)")
    if auto.dtype != torch.float64 or not err < 1e-12:
        raise AssertionError(f"f64 'auto' evaluation: {auto.dtype}, {err}")
    del bodies, pos64, mass64, auto, plain

    print(f"    times (CUDA events, 1 warm-up, median of 3), {smi}")
    times = {}
    for n, dim, theta in BH_TIMED:
        bodies = random_system(n, dim, generator=gen, device=dev)
        pos, mass = bodies.positions, bodies.masses
        rp, tree = bh_tree(gt, pos, mass, theta)
        k, L = rp["k"], rp["leaf_level"]
        kw = dict(k=k, softening=default.softening, multipole="quad",
                  far_impl=rp["far_impl"])
        row = {
            "eval": time_ms(lambda: gt.barnes_hut_grid(pos, mass, default,
                                                       theta=theta)),
            "eval_plain_near": time_ms(lambda: gt.barnes_hut_grid(
                pos, mass, default, theta=theta, p2p_impl="plain")),
            "capacity": time_ms(lambda: gt.compute_capacity(pos, L)),
            "build": time_ms(lambda: gt.build_grid_tree(
                pos, mass, L, tree.capacity, quad=True)),
            "near": time_ms(lambda: gt.grid_tree_accel_sorted(
                tree, p2p_impl="cuda", _debug_skip="far", **kw)),
            "near_plain": time_ms(lambda: gt.grid_tree_accel_sorted(
                tree, p2p_impl="plain", _debug_skip="far", **kw)),
            "far": time_ms(lambda: gt.grid_tree_accel_sorted(
                tree, _debug_skip="near", **kw)),
        }
        if rp["far_impl"] == "hier":
            row["hier_sweep"] = time_ms(lambda: hier_far_coeffs(
                tree, k, multipole="quad"))
        # The tree kernel alone: one launch over every leaf on the tree's
        # own buffers, as the path makes it.
        bufs = cuda_p2p.near_field_buffers(tree)
        out32 = torch.zeros((tree.n, dim), dtype=torch.float32, device=dev)
        row["k6_one_launch"] = time_ms(lambda: cuda_p2p.near_field_launch(
            bufs, out32, dim=dim, leaf_level=L, k=k, leaf0=0,
            nleaves=tree.num_leaf_cells, softening=default.softening))
        row["k6_launches"] = rp["num_segments"]
        row["k6_pairs"] = cuda_p2p.near_field_pairs(tree, k)
        row["leaf_level"], row["capacity_value"] = L, tree.capacity
        key = f"{n}_{dim}d_theta{theta}"
        times[key] = row
        print(f"    N={n} {dim}D theta={theta} (k={k}, L={L}, capacity "
              f"{tree.capacity}, {rp['far_impl']}): "
              + ", ".join(f"{a} {b:.3f} ms" if isinstance(b, float)
                          else f"{a} {b}" for a, b in row.items()))
        if key == BH_K6_TIMED:
            # The window entry on the path's first window of the old layout:
            # the kernel alone, and the whole wrapper (packing, output,
            # launch, cast back).
            t, s = k6_calls(gt, tree, k)[0]
            wbufs = cuda_p2p.p2p_leaf_pack(t, s)
            out.update(
                k6_ms=row["k6_one_launch"], k6_pairs=row["k6_pairs"],
                k6_bytes=(tree.n * 16 + 2 * tree.num_leaf_cells * 8
                          + tree.n * dim * 4),
                k6_plain_ms=time_ms(lambda: cuda_p2p.near_field_plain(
                    tree, k, default.softening)),
                k6_dim=dim,
                window_ms=time_ms(lambda: cuda_p2p.p2p_leaf_launch(
                    *wbufs, dim, default.softening)),
                window_wrapper_ms=time_ms(lambda: cuda_p2p.p2p_leaf_cuda(
                    t, s, softening=default.softening)),
                window_shape=f"{tuple(t.shape)} x {tuple(s.shape)}")
            del t, s, wbufs
        del bodies, pos, mass, tree, bufs, out32
    out["times"] = times
    return out


def fmm_far_allowance(fm, tree64, order) -> torch.Tensor:
    """Each sorted body's far-field fp32 allowance: FMM_FAR_ULPS fp32 ulps
    of its L2P term sum |Σ_m |∇S_m| |w_m|| (the f64 local weights w)."""
    dim, L = tree64.dim, tree64.leaf_level
    Tt, m2m = fm._tables(dim, order, torch.float64, tree64.lo.device)
    W = fm._m2m(fm._p2m_dense(tree64, order, 1024, Tt), m2m, dim, L)
    lw_leaf = fm._l2l(fm._m2l(tree64, W, order, 1), m2m, L,
                      tree64.num_leaf_cells, W[L])
    half = tree64.cell_sizes[L] / 2
    out = []
    for b0 in range(0, tree64.n, 1 << 16):
        sl = slice(b0, b0 + (1 << 16))
        leaf = tree64.leaf_ids[sl]
        y = (tree64.pos_sorted[sl] - fm._cell_centers(tree64, leaf)) / half
        s, ds = fm._interp_and_grad_1d(order, y, Tt)
        s, ds = s.abs().unbind(1), ds.abs().unbind(1)
        lw = lw_leaf[leaf].abs()
        out.append(torch.stack([
            (fm._outer_basis([ds[e] if e == d else s[e] for e in range(dim)])
             * lw).sum(-1) / half[d] for d in range(dim)], dim=-1).norm(dim=-1))
    return FMM_FAR_ULPS * 2.0 ** -24 * torch.cat(out)


def fmm_phase_times(fm, gt, cuda_p2p, pos, mass, cfg, order) -> dict:
    """CUDA-event times (1 warm-up, median of 3) of one fp32 evaluation and
    of its phases on its own tree; the M2L's operations and FLOP bound."""
    n, dim = pos.shape
    L = gt.auto_leaf_level(n, dim)
    tree = gt.build_grid_tree(pos, mass, L, gt.compute_capacity(pos, L))
    Tt, m2m = fm._tables(dim, order, pos.dtype, pos.device)
    nl = tree.num_leaf_cells
    W = fm._m2m(fm._p2m_dense(tree, order, 1024, Tt), m2m, dim, L)
    Lc = fm._m2l(tree, W, order, 1)
    nD = order ** dim
    m2l_flops = sum(2 * (1 << (dim * l)) * len(fm._v_list_deltas(dim, 1))
                    * nD * nD for l in range(2, L + 1))
    row = {
        "eval": time_ms(lambda: fm.fmm_forces(pos, mass, cfg, order=order)),
        "build": time_ms(lambda: gt.build_grid_tree(
            pos, mass, L, gt.compute_capacity(pos, L))),
        "p2m_m2m": time_ms(lambda: fm._m2m(
            fm._p2m_dense(tree, order, 1024, Tt), m2m, dim, L)),
        "m2l": time_ms(lambda: fm._m2l(tree, W, order, 1)),
        "l2l_l2p": time_ms(lambda: fm._l2p(
            tree, fm._l2l(dict(Lc), m2m, L, nl, W[L]), order, Tt)),
        "p2p_k6": time_ms(lambda: cuda_p2p.near_field_cuda(
            tree, 1, cfg.softening, 0, nl)),
        "m2l_gflop": m2l_flops / 1e9,
        "m2l_bound_ms": m2l_flops / FP32_PEAK * 1e3,
        "k6_pairs": cuda_p2p.near_field_pairs(tree, 1),
        "leaf_level": L, "capacity": tree.capacity,
    }
    del tree, W, Lc
    return row


def phase_fmm(cb, gen, dev, default, smi) -> dict:
    """[14] The FMM tier on the card, order 8, dense layout: Simulation,
    CLI -m f and one 4M 3D evaluation with K6 held to one launch per fp32
    evaluation; TF32 refused; the f64 runs against the f64 oracle, the fp32
    runs against the f64 FMM on the same tree; FMM's near phase against the
    Barnes-Hut theta = 0.5 near phase, bit for bit; the phase times."""
    from nbody_tpu_torch import Simulation, cli
    from nbody_tpu_torch.config import FMM_ORDER
    from nbody_tpu_torch.ops import cuda_p2p, fmm as fm, grid_tree as gt
    from nbody_tpu_torch.state import random_system
    from nbody_tpu_torch.utils.accuracy import scale_normalized_error
    order = FMM_ORDER
    out = {"launches": 0}
    print(f"[14] FMM tier, order {order}, dense layout: TF32 refused, "
          "Simulation, CLI -m f, 4M 3D, accuracy, near phase vs Barnes-Hut, "
          "times")
    probe = random_system(4096, 2, generator=gen, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fm.fmm_forces(probe.positions, probe.masses, default, order=order)
        raise AssertionError("fmm_forces ran with allow_tf32 on")
    except RuntimeError as e:
        if "allow_tf32" not in str(e):
            raise
        print(f"    allow_tf32 = True: refused ({e})")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

    n, dim = FMM_SIM
    bodies = random_system(n, dim, generator=torch.Generator().manual_seed(
        FMM_SEED), device=dev)
    sim = Simulation.create(bodies, default, method="fmm")
    print(f"    Simulation('fmm').run(steps=1), N={n} {dim}D leapfrog")
    reset_launches()
    t0 = time.perf_counter()
    sim = sim.run(steps=1, dt=1e-3)
    torch.cuda.synchronize()
    launches = dict(counts())
    print(f"    ran in {time.perf_counter() - t0:.2f} s")
    expect_launches(f"Simulation('fmm') N={n} {dim}D", launches,
                    {"near_field": 2, "p2p_leaf": 0})
    out["launches"] += launches["near_field"]
    if not (bool(torch.isfinite(sim.system.positions).all())
            and sim.step_count == 1):
        raise AssertionError("Simulation('fmm') state not finite")
    del sim

    n, dim = FMM_CLI
    args = ["-d", str(dim), "-N", str(n), "-m", "f", "-a", "1", "--no-files",
            "--device", "cuda"]
    print(f"    CLI: {' '.join(args)}")
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    launches = dict(counts())
    print(buf.getvalue(), end="")
    if rc != 0:
        raise AssertionError(f"CLI -m f rc {rc}")
    # One warm-up and one timed evaluation, one launch each.
    expect_launches(f"CLI -m f N={n} {dim}D", launches,
                    {"near_field": 2, "p2p_leaf": 0})
    out["launches"] += launches["near_field"]
    m = re.search(r"FMM_Chebyshev accuracy: ([0-9.]+)% \(norm err "
                  r"([0-9.e+-]+)", buf.getvalue())
    if m is None:
        raise AssertionError("CLI -m f printed no accuracy line")
    print(f"    FMM_Chebyshev vs BruteForce_CUDA (both fp32): {m.group(1)}%,"
          f" norm err {m.group(2)} (printed, not held: see the fp32 floor "
          "below)")

    n, dim = FMM_BIG
    big = random_system(n, dim, generator=gen, device=dev)
    rows = sample_rows(n, gen, dev)
    print(f"    fmm_forces N={n} {dim}D, order {order}, one evaluation")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    got = fm.fmm_forces(big.positions, big.masses, default, order=order)
    torch.cuda.synchronize()
    launches = dict(counts())
    print(f"    ran in {time.perf_counter() - t0:.2f} s (cold), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    expect_launches(f"fmm_forces N={n} {dim}D", launches,
                    {"near_field": 1, "p2p_leaf": 0})
    out["launches"] += launches["near_field"]
    if tuple(got.shape) != (n, dim) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"fmm_forces 4M 3D: shape {tuple(got.shape)}, "
                             "not finite")
    err = float(scale_normalized_error(
        got[rows].double(), oracle64(cb, big.positions, big.masses, default,
                                     rows)))
    print(f"    fp32 vs the f64 oracle on {rows.numel()} sampled rows: "
          f"{err:.3e} (printed)")
    out["err_4m_3d"] = err
    del big, got

    print(f"    accuracy: f64 runs vs the f64 oracle on {BH_ROWS} sampled "
          f"rows (held to {FMM_GATE:g}); fp32 vs f64 on the same tree (held "
          "to the near floor + the far floor)")
    for n, dim in (FMM_SIM, FMM_CLI):
        bodies = random_system(n, dim, generator=torch.Generator()
                               .manual_seed(FMM_SEED + dim), device=dev)
        pos, mass = bodies.positions, bodies.masses
        rows = torch.randperm(n, generator=torch.Generator().manual_seed(
            FMM_SEED + 10 + dim))[:BH_ROWS].to(dev)
        want = oracle64(cb, pos, mass, default, rows)
        reset_launches()
        f64 = fm.fmm_forces(pos.double(), mass.double(), default,
                            order=order)
        torch.cuda.synchronize()
        expect_launches(f"f64 fmm_forces N={n} {dim}D (p2p_impl 'auto')",
                        counts(), {"near_field": 0, "p2p_leaf": 0})
        err64 = check_close(f"N={n} {dim}D f64 FMM vs f64 oracle",
                            f64[rows], want, tol=FMM_GATE)
        f32 = fm.fmm_forces(pos, mass, default, order=order)
        err32 = float(scale_normalized_error(f32[rows].double(), want))
        err3264 = float(scale_normalized_error(f32.double(), f64))
        print(f"    N={n} {dim}D fp32 FMM: vs the f64 oracle {err32:.3e}, vs "
              f"the f64 FMM (own trees) {err3264:.3e} (printed)")
        L = gt.auto_leaf_level(n, dim)
        tree = gt.build_grid_tree(pos, mass, L, gt.compute_capacity(pos, L))
        t64 = tree_f64(gt, tree)
        a64 = fm.fmm_accel_sorted(t64, order=order,
                                  softening=default.softening)
        a32 = fm.fmm_accel_sorted(tree, order=order,
                                  softening=default.softening,
                                  p2p_impl="auto")
        # Held per body: |a32 − a64| ≤ the near floor × RMS + the body's
        # far allowance.
        rms = float(a64.norm(dim=-1).pow(2).mean().sqrt())
        near_tol = max(1e-5, fp32_floor(a64, K6_ULPS))
        far = fmm_far_allowance(fm, t64, order)
        diff = (a32.double() - a64).norm(dim=-1)
        excess = float((diff - far).max()) / rms
        print(f"    N={n} {dim}D fp32 (K6) vs f64 FMM, same tree: "
              f"scale-normalized err {float(diff.max()) / rms:.3e}; beyond "
              f"each body's far allowance ({FMM_FAR_ULPS} ulps of its L2P "
              f"term sum, largest {float(far.max()) / rms:.3e} of the RMS) "
              f"{excess:.3e} (tol: the near floor {near_tol:.3e}, "
              f"{K6_ULPS} ulps of the largest force), finite "
              f"{bool(torch.isfinite(a32).all())}")
        if not (bool(torch.isfinite(a32).all()) and excess <= near_tol):
            raise AssertionError(f"N={n} {dim}D fp32 FMM: {excess} beyond "
                                 f"the far allowance > {near_tol}")
        out[f"err_{n}_{dim}d"] = {
            "f64_vs_oracle": float(scale_normalized_error(f64[rows], want)),
            "f64_vs_oracle_max_abs": err64, "f32_vs_oracle": err32}
        del bodies, f64, f32, tree, t64, a64, a32

    # FMM's near phase and Barnes-Hut theta = 0.5's make the same K6 launch
    # on the same cells: k = 1, the same leaf level and capacity.
    n, dim = FMM_SIM
    bodies = random_system(n, dim, generator=torch.Generator().manual_seed(
        FMM_SEED), device=dev)
    pos, mass = bodies.positions, bodies.masses
    rp, bh_tree_ = bh_tree(gt, pos, mass, 0.5)
    L = gt.auto_leaf_level(n, dim)
    tree = gt.build_grid_tree(pos, mass, L, gt.compute_capacity(pos, L))
    if (rp["k"], rp["leaf_level"], bh_tree_.capacity) != (1, L,
                                                          tree.capacity):
        raise AssertionError(f"FMM tree (1, {L}, {tree.capacity}) != "
                             f"Barnes-Hut theta=0.5 {rp}, capacity "
                             f"{bh_tree_.capacity}")
    reset_launches()
    near_fmm = fm.fmm_accel_sorted(tree, order=order,
                                   softening=default.softening,
                                   p2p_impl="auto", _debug_skip="m2l,l2p")
    near_bh = gt.grid_tree_accel_sorted(
        bh_tree_, k=1, softening=default.softening, p2p_impl="auto",
        multipole="quad", far_impl=rp["far_impl"], _debug_skip="far")
    torch.cuda.synchronize()
    expect_launches("near phases, FMM and Barnes-Hut theta=0.5", counts(),
                    {"near_field": 2, "p2p_leaf": 0})
    same = torch.equal(near_fmm, near_bh)
    print(f"    N={n} {dim}D near phase: FMM (_debug_skip='m2l,l2p') vs "
          f"Barnes-Hut theta=0.5 (_debug_skip='far'), L={L}, capacity "
          f"{tree.capacity}: bit-identical {same}")
    if not same:
        raise AssertionError("FMM's near phase differs from Barnes-Hut's")
    del bodies, tree, bh_tree_, near_fmm, near_bh

    print(f"    times (CUDA events, 1 warm-up, median of 3), {smi}; the "
          "reference's rows: BASELINE.md:43-50 (reference CPU)")
    times = {}
    for n, dim in FMM_TIMED:
        bodies = random_system(n, dim, generator=gen, device=dev)
        row = fmm_phase_times(fm, gt, cuda_p2p, bodies.positions,
                              bodies.masses, default, order)
        times[f"{n}_{dim}d"] = row
        print(f"    N={n} {dim}D (L={row['leaf_level']}, capacity "
              f"{row['capacity']}): " + ", ".join(
                  f"{a} {b:.3f}" if isinstance(b, float) else f"{a} {b}"
                  for a, b in row.items()
                  if a not in ("leaf_level", "capacity"))
              + f" ms; reference: {FMM_REFERENCE_S[(n, dim)]}")
        del bodies
    out["times"] = times
    return out


def phase_sparse(cb, gen, dev, default, smi) -> dict:
    """[15] The sparse grid on the clustered input the dense grid refuses:
    Barnes-Hut theta = 0.25 and FMM under layout="auto" take their sparse
    layouts (no K6 launch), against the f64 oracle; then the sparse
    Barnes-Hut layout beside the dense one on uniform bodies."""
    from nbody_tpu_torch import GravityConfig
    from nbody_tpu_torch.config import FMM_ORDER
    from nbody_tpu_torch.ops import fmm as fm, grid_tree as gt
    from nbody_tpu_torch.ops import sparse_grid as sg
    from nbody_tpu_torch.state import plummer_system, random_system
    from nbody_tpu_torch.utils.accuracy import scale_normalized_error
    n = SPARSE_N
    cfg = GravityConfig(G=1.0, softening=4.0 / n)
    print(f"[15] sparse grid: Plummer N={n} 3D (G=1, softening 4/N), "
          "layout='auto'")
    bodies = plummer_system(n, 3, generator=torch.Generator().manual_seed(
        SPARSE_SEED), device=dev)
    pos, mass = bodies.positions, bodies.masses
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(
        SPARSE_SEED + 1))[:BH_ROWS].to(dev)
    want = oracle64(cb, pos, mass, cfg, rows)
    out = {}
    calls = []
    real_bh, real_stats = sg.barnes_hut_sparse, sg.sparse_grid_stats

    def bh_counted(*a, **k):
        calls.append("barnes_hut_sparse")
        return real_bh(*a, **k)

    def stats_counted(*a, **k):
        calls.append("sparse_grid_stats")
        return real_stats(*a, **k)

    rp = gt.resolve_bh_params(n, 3, 0.25)
    for name, fn, L, tol in (
            ("barnes_hut_grid theta=0.25", lambda: gt.barnes_hut_grid(
                pos, mass, cfg, theta=0.25), rp["leaf_level"], SPARSE_BH_TOL),
            (f"fmm_forces order={FMM_ORDER}", lambda: fm.fmm_forces(
                pos, mass, cfg, order=FMM_ORDER), gt.auto_leaf_level(n, 3),
             FMM_GATE)):
        cap = gt.compute_capacity(pos, L)
        if not gt.dense_layout_degenerate(cap, n, L, 3):
            raise AssertionError(f"{name}: capacity {cap} at L={L} is not "
                                 "degenerate")
        calls.clear()
        sg.barnes_hut_sparse, sg.sparse_grid_stats = bh_counted, stats_counted
        reset_launches()
        try:
            got = fn()
            torch.cuda.synchronize()
        finally:
            sg.barnes_hut_sparse, sg.sparse_grid_stats = real_bh, real_stats
        print(f"    {name}: leaf level {L}, densest leaf {cap} bodies; "
              f"sparse calls {calls}")
        if "sparse_grid_stats" not in calls:
            raise AssertionError(f"{name} did not take the sparse layout")
        expect_launches(name, counts(), {"near_field": 0, "p2p_leaf": 0})
        err = check_close(f"{name} vs f64 oracle, {rows.numel()} sampled "
                          "rows", got[rows], want, tol=tol)
        ms = time_ms(fn)
        print(f"    {name}: {ms:.3f} ms an evaluation (capacity probe and "
              f"sparse_grid_stats included; CUDA events, 1 warm-up, median of "
              f"3), {smi}")
        out[name] = {"ms": ms, "max_abs_err": err, "err": float(
            scale_normalized_error(got[rows].double(), want))}
        del got
    del bodies, pos, mass

    n, dim = SPARSE_UNIFORM
    bodies = random_system(n, dim, generator=gen, device=dev)
    t = {layout: time_ms(lambda: gt.barnes_hut_grid(
        bodies.positions, bodies.masses, default, layout=layout))
        for layout in ("dense", "sparse")}
    dense = gt.barnes_hut_grid(bodies.positions, bodies.masses, default,
                               layout="dense")
    sparse = gt.barnes_hut_grid(bodies.positions, bodies.masses, default,
                                layout="sparse")
    diff = float(scale_normalized_error(sparse.double(), dense.double()))
    print(f"    barnes_hut_grid N={n} {dim}D uniform theta={default.theta}: "
          f"dense {t['dense']:.3f} ms, sparse {t['sparse']:.3f} ms; sparse "
          f"vs dense {diff:.3e} (both fp32; printed), {smi}")
    out["uniform_1e6_2d"] = dict(t, diff=diff)
    return out


def probe_tol(op) -> float:
    """P against its plain version, max relative difference. rsqrtf and
    rcp.approx are within 2 ulp of the plain version's correctly rounded
    results at each of the few iterations; one bf16 ulp is 2^-8. The other
    f32 ops round as the plain version does (its FMA rounds x·c + d once
    from an exact f64 product), so they agree to the bit, also over the
    timed FMA launch's 16,384 iterations; 4e-6 leaves room for the
    approximate ops only."""
    return 2.0 ** -8 if op.dtype == torch.bfloat16 else 4e-6


def phase_probe(cb, gen, dev, smi) -> dict:
    """[13] The rate probe P: its kernels vs their plain versions, then
    the tool's run with its launches counted."""
    from nbody_tpu_torch.tools import microbench as mb
    print(f"[13] rate probe P vs its plain version at the tool's block "
          f"{mb.BLOCK}, then its rates")
    for op in mb.OPS:
        x = (0.5 + torch.rand(mb.BLOCK, generator=gen)).to(dev, op.dtype)
        got = mb.rate_probe(op, x, PROBE_ITERS_SMALL).float()
        want = mb.rate_probe_plain(op, x, PROBE_ITERS_SMALL).float()
        rel = float(((got - want).abs() / want.abs()).max())
        print(f"  {op.name} x{PROBE_ITERS_SMALL}: max rel diff {rel:.3e} "
              f"(tol {probe_tol(op):g})")
        if not rel <= probe_tol(op):
            raise AssertionError(f"P {op.name}: {rel}")
    m, s = mb.MATMUL_SHAPE
    reps = mb.MATMUL_REPS
    print(f"    matmul probe vs f64 plain, {reps} repeats (tol {MATMUL_TOL:g}); "
          f"times: CUDA events, 1 warm-up, median of 3, {smi}")
    mm = {}
    for mi, si, kk in [(m, s, kk) for kk in mb.MATMUL_KS] + MATMUL_RAGGED:
        a = torch.rand((mi, si), generator=gen).to(dev)
        b = torch.rand((si, kk), generator=gen).to(dev)
        label = f"({mi},{si})@({si},{kk}) x{reps}"
        got = mb.matmul_probe(a, b, reps)
        err = check_close(f"matmul probe {label}", got,
                          mb.matmul_probe_plain(a.double(), b.double(), reps),
                          tol=MATMUL_TOL)
        if not torch.equal(got, mb.matmul_probe(a, b, reps)):
            raise AssertionError(f"matmul probe {label}: two launches differ")
        if (mi, si) != (m, s):
            continue
        # The library's one call for the same sum (TF32 off): the repeats
        # laid end to end along S, built outside the timing.
        a_rep, b_rep = a.repeat(1, reps), b.repeat(reps, 1)
        mm[kk] = {"max_abs_err": err,
                  "ms": time_ms(lambda: mb.matmul_probe(a, b, reps)),
                  "plain_ms": time_ms(lambda: mb.matmul_probe_plain(a, b,
                                                                    reps)),
                  "library_ms": time_ms(lambda: torch.matmul(a_rep, b_rep))}
        print(f"    {label}: kernel {mm[kk]['ms']:.4f} ms, plain "
              f"{mm[kk]['plain_ms']:.4f} ms, torch.matmul fp32 "
              f"{mm[kk]['library_ms']:.4f} ms")
        del a_rep, b_rep
    print(f"    python -m nbody_tpu_torch.tools.microbench, {smi}")
    reset_launches()
    rates = mb.run(iters=PROBE_ITERS, device=dev, log=lambda s: print("  " + s))
    torch.cuda.synchronize()
    launches = dict(counts())
    expect_launches("microbench", launches,
                    {"rate_probe": 2 * len(mb.OPS),
                     "matmul_probe": 2 * len(mb.MATMUL_KS)})
    fma = mb.OPS_BY_NAME["f32 fma"]
    x = torch.full(mb.BLOCK, 1.5, device=dev)
    got = mb.rate_probe(fma, x, PROBE_ITERS_TIMED)
    want = mb.rate_probe_plain(fma, x, PROBE_ITERS_TIMED)
    diff = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    print(f"  f32 fma x{PROBE_ITERS_TIMED} (the timed launch): max rel diff "
          f"{rel:.3e} (tol {probe_tol(fma):g}), max abs diff {diff:.3e}")
    if not rel <= probe_tol(fma):
        raise AssertionError(f"P f32 fma x{PROBE_ITERS_TIMED}: {rel}")
    # `ms` is one launch timed alone, as every kernel's; it takes in the
    # host's time to enqueue the launch while the card idles. The share of
    # one launch in a run of 10 leaves that out.
    def fma_launch():
        return mb.rate_probe(fma, x, PROBE_ITERS_TIMED)

    fma_t = {"ms": time_ms(fma_launch),
             "ms_run_of_10": time_ms(fma_launch, launches=10),
             "plain_ms": time_ms(lambda: mb.rate_probe_plain(
                 fma, x, PROBE_ITERS_TIMED), reps=1),
             "max_abs_err": diff}
    flops = x.numel() * PROBE_ITERS_TIMED
    fma_t["rate"] = flops / (fma_t["ms"] * 1e-3)
    fma_t["rate_run_of_10"] = flops / (fma_t["ms_run_of_10"] * 1e-3)
    print(f"  f32 fma x{PROBE_ITERS_TIMED}: {fma_t['ms']:.4f} ms timed alone "
          f"({fma_t['rate']:.4e} FFMA/s), {fma_t['ms_run_of_10']:.4f} ms a "
          f"launch in a run of 10 ({fma_t['rate_run_of_10']:.4e} FFMA/s); "
          f"the tool's run at {PROBE_ITERS} iterations: f32 fma "
          f"{rates['ops'][fma.name]['rate']:.4e}/s, f32 mul "
          f"{rates['ops']['f32 mul']['rate']:.4e}/s")
    return {"launches": launches, "rates": rates, "fma": fma_t, "mm": mm}


def bound(flops, nbytes, rsqrts) -> dict:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the memory rate, with the MUFU
    rsqrt time beside it (not in bound_ms: the data sheet gives no such
    peak)."""
    t_ops = flops / FP32_PEAK * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "mufu_bound_ms": rsqrts / MUFU_RATE * 1e3}


def per_step_ms(run) -> float:
    """Per-step time from runs of K_LO and K_HI steps (launch and set-up
    cancel in the difference)."""
    lo, hi = time_ms(lambda: run(K_LO)), time_ms(lambda: run(K_HI))
    return (hi - lo) / (K_HI - K_LO)


def phase_times(cb, gen, dev, default, smi) -> dict:
    """[7] CUDA-event times of every kernel beside its plain version."""
    from nbody_tpu_torch import GravityConfig
    from nbody_tpu_torch.integrators import simulate
    from nbody_tpu_torch.state import plummer_system, random_system
    print(f"[7] times (CUDA events, 1 warm-up, median of 3), {smi}")
    head = random_system(HEADLINE_N, 2, generator=gen, device=dev)
    big = {mode: time_ms(lambda: cb.brute_force_cuda(
        head.positions, head.masses, default, mode=mode))
        for mode in ("symmetric", "precise")}
    print(f"    N={HEADLINE_N} 2D fp32: K1 symmetric {big['symmetric']:.3f} ms,"
          f" K2 precise {big['precise']:.3f} ms")
    del head
    # The plain versions take minutes at 2^20, so every kernel is also
    # timed at TIMED_N, where the plain ones finish in seconds.
    small = random_system(TIMED_N, 2, generator=gen, device=dev)
    p, mm = small.positions, small.masses
    soft = default.softening
    pair = random_system(2 * TIMED_N, 2, generator=gen, device=dev)
    tp, sp = pair.positions[:TIMED_N], pair.positions[TIMED_N:]
    tm, sm = pair.masses[:TIMED_N], pair.masses[TIMED_N:]
    t = {
        "K1": time_ms(lambda: cb.brute_force_cuda(p, mm, default,
                                                  mode="symmetric")),
        "K1_plain": time_ms(lambda: cb.symmetric_forces_plain(p, mm, default)),
        "K2": time_ms(lambda: cb.brute_force_cuda(p, mm, default,
                                                  mode="precise")),
        "K2_plain": time_ms(lambda: (default.G * mm)[:, None]
                            * cb.pairwise_accel_plain(p, p, mm, soft)),
        "K3": time_ms(lambda: cb.sym_tile_cuda(tp, tm, sp, sm, soft)),
        "K3_plain": time_ms(lambda: cb.sym_tile_plain(tp, tm, sp, sm, soft)),
        "K5": time_ms(lambda: cb.brute_force_cuda(p, mm, default,
                                                  mode="mxu")),
        "K5_plain": time_ms(lambda: (default.G * mm)[:, None]
                            * cb.mxu_accel_plain(p, p, mm, soft, 256)),
    }
    print(f"    N={TIMED_N} 2D fp32 (K3: {TIMED_N} x {TIMED_N} cross tile): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    del small, pair
    small = random_system(TIMED_N, 3, generator=gen, device=dev)
    pair = random_system(2 * TIMED_N, 3, generator=gen, device=dev)
    t["K1_3d"] = time_ms(lambda: cb.brute_force_cuda(
        small.positions, small.masses, default, mode="symmetric"))
    t["K3_3d"] = time_ms(lambda: cb.sym_tile_cuda(
        pair.positions[:TIMED_N], pair.masses[:TIMED_N],
        pair.positions[TIMED_N:], pair.masses[TIMED_N:], soft))
    print(f"    N={TIMED_N} 3D fp32: K1 {t['K1_3d']:.3f} ms, K3 "
          f"{t['K3_3d']:.3f} ms ({TIMED_N} x {TIMED_N} cross tile)")
    del small, pair

    seg = random_system(SEG_N, 2, generator=gen, device=dev)
    t["segmented_2e6"] = time_ms(lambda: cb.brute_force_cuda_segmented(
        seg.positions, seg.masses, default))
    t["K1_2e6"] = time_ms(lambda: cb.brute_force_cuda(
        seg.positions, seg.masses, default, mode="symmetric"))
    print(f"    N={SEG_N} 2D fp32: segmented (2 segments: 2 K1 + 1 K3) "
          f"{t['segmented_2e6']:.3f} ms, one K1 launch {t['K1_2e6']:.3f} ms")
    del seg

    unit = GravityConfig(G=1.0, softening=0.1)
    for n, dim in ((SMALL_N, 2), (FUSED_N, 3)):
        s = plummer_system(n, dim, generator=gen, device=dev)
        state = (s.positions, s.velocities, s.masses)
        kw = {"g": unit.G, "softening": unit.softening, "dt": 1e-3,
              "integrator": "euler"}
        forces = lambda q, m: cb.brute_force_cuda(  # noqa: E731
            q, m, unit, mode="precise")
        key = f"{n}_{dim}d"
        t[f"K4_{key}"] = per_step_ms(lambda k: cb.fused_smalln_simulate(
            *state, num_steps=k, **kw))
        t[f"K4_leapfrog_{key}"] = per_step_ms(
            lambda k: cb.fused_smalln_simulate(
                *state, num_steps=k, **dict(kw, integrator="leapfrog")))
        t[f"K4_plain_{key}"] = per_step_ms(lambda k: cb.fused_smalln_plain(
            *state, num_steps=k, **kw))
        t[f"stepped_{key}"] = per_step_ms(lambda k: simulate(
            s, forces, 1e-3, k, integrator="euler"))
        print(f"    N={n} {dim}D, ms per step (K={K_LO}..{K_HI}): K4 Euler "
              f"{t[f'K4_{key}']:.5f}, K4 leapfrog "
              f"{t[f'K4_leapfrog_{key}']:.5f}; Euler plain "
              f"{t[f'K4_plain_{key}']:.5f}, stepped path (simulate + K2) "
              f"{t[f'stepped_{key}']:.5f}")
    t["big"] = big
    return t


def kernels_line(t, launches, k1_err, k2_err, k3, k4, k5, k6, bh, fmm, pr,
                 ptxas) -> list:
    """The kernels JSON line: every kernel with its launches on its path,
    its error against its plain version, its times and its bound."""
    from nbody_tpu_torch.tools import microbench as mb
    # Bounds from the JAX kernels' own operation counts per pair
    # (pallas_brute.py:256, :331, :338, :686, :963; pallas_p2p.py:89), on
    # this run's shapes: distinct pairs, each input read and each output
    # written once, one rsqrt per pair. No PyTorch call computes a softened
    # gravity sum, so K1-K6 have no library time.
    n, n2 = TIMED_N, TIMED_N * (TIMED_N - 1)
    io_2d, io_3d = n * (16 + 8), n * (16 + 12)
    bounds = {
        "K1": bound(17 * n2 / 2, io_2d, n2 / 2),
        "K1_3d": bound(21 * n2 / 2, io_3d, n2 / 2),
        "K3_3d": bound(21 * n * n, 2 * io_3d, n * n),
        "K2": bound(16 * n2, io_2d, n2),
        "K3": bound(17 * n * n, 2 * io_2d, n * n),
        "K4": bound(17 * SMALL_N * (SMALL_N - 1), SMALL_N * 64,
                    SMALL_N * (SMALL_N - 1)),
        "K4_3d": bound(21 * FUSED_N * (FUSED_N - 1), FUSED_N * 64,
                       FUSED_N * (FUSED_N - 1)),
        "K5": bound(26 * n2, io_2d, n2),
        "K6": bound((3 * bh["k6_dim"] + 6) * bh["k6_pairs"], bh["k6_bytes"],
                    bh["k6_pairs"]),
    }
    nblk = mb.BLOCK[0] * mb.BLOCK[1]
    (mm_m, mm_s), mm = mb.MATMUL_SHAPE, pr["mm"]
    p_bounds = {"rate": bound(2 * nblk * PROBE_ITERS_TIMED, 2 * nblk * 4, 0)}
    for kk in mb.MATMUL_KS:
        p_bounds[kk] = bound(2 * mm_m * mm_s * kk * mb.MATMUL_REPS,
                             (mm_m * mm_s + mm_s * kk + mm_m * kk) * 4, 0)
    bh_t = bh["times"][BH_K6_TIMED]
    n3_ptxas = {k: v for k, v in ptxas.items()
                if re.match(r"newton3_kernel|diagonal_kernel", k)}

    timed_at = f"N={TIMED_N} 2D fp32"
    big = t["big"]
    kernels = [
        {"name": "K1 symmetric (Newton-3 block pairs)", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/symmetric.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:135",
         "launches": launches["symmetric"], "max_abs_err": k1_err,
         "ms": t["K1"], "plain_ms": t["K1_plain"], "timed_at": timed_at,
         "ms_n1048576_2d": big["symmetric"], "ms_n2e6_2d": t["K1_2e6"],
         "ms_n262144_3d": t["K1_3d"],
         "bound_ms_n262144_3d": bounds["K1_3d"]["bound_ms"],
         "ptxas": {k: v for k, v in n3_ptxas.items()
                   if k.endswith(",1>") or k.startswith("diagonal")},
         **bounds["K1"], "library_ms": None},
        {"name": "K2 precise (one-sided tile)", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/precise.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:78",
         "launches": launches["precise"], "max_abs_err": k2_err,
         "ms": t["K2"], "plain_ms": t["K2_plain"], "timed_at": timed_at,
         "ms_n1048576_2d": big["precise"], **bounds["K2"],
         "library_ms": None},
        {"name": "K3 sym tile (Newton-3 rectangle, segmented driver)",
         "route": "cuda", "source": "nbody_tpu_torch/csrc/sym_tile.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:497",
         "launches": k3["launches"], "max_abs_err": k3["max_abs_err"],
         "ms": t["K3"], "plain_ms": t["K3_plain"],
         "timed_at": f"{TIMED_N} x {TIMED_N} 2D fp32 cross tile",
         "segmented_ms_n2e6_2d": t["segmented_2e6"],
         "ms_n262144_3d": t["K3_3d"],
         "bound_ms_n262144_3d": bounds["K3_3d"]["bound_ms"],
         "ptxas": {k: v for k, v in n3_ptxas.items()
                   if k.startswith("newton3") and k.endswith(",0>")},
         **bounds["K3"], "library_ms": None},
        {"name": "K4 fused small-N steps", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/fused_steps.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:849",
         "launches": k4["launches"], "max_abs_err": k4["max_abs_err"],
         "ms": t[f"K4_{SMALL_N}_2d"], "plain_ms": t[f"K4_plain_{SMALL_N}_2d"],
         "timed_at": f"per Euler step, N={SMALL_N} 2D fp32",
         "stepped_ms": t[f"stepped_{SMALL_N}_2d"],
         "ms_leapfrog": t[f"K4_leapfrog_{SMALL_N}_2d"],
         "ms_n2048_3d": t[f"K4_{FUSED_N}_3d"],
         "ms_n2048_3d_leapfrog": t[f"K4_leapfrog_{FUSED_N}_3d"],
         "plain_ms_n2048_3d": t[f"K4_plain_{FUSED_N}_3d"],
         "stepped_ms_n2048_3d": t[f"stepped_{FUSED_N}_3d"],
         "bound_ms_n2048_3d": bounds["K4_3d"]["bound_ms"],
         "cluster_size": k4["cluster"],
         "ptxas": {k: v for k, v in ptxas.items()
                   if k.startswith("fused_steps")},
         **bounds["K4"], "library_ms": None},
        {"name": "K5 mxu (block-centred matmul-form tile)", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/mxu.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:264",
         "launches": k5["launches"], "max_abs_err": k5["max_abs_err"],
         "ms": t["K5"], "plain_ms": t["K5_plain"], "timed_at": timed_at,
         "k2_ms": t["K2"], **bounds["K5"], "library_ms": None},
        {"name": "K6 near field (tree kernel; window entry p2p_leaf)",
         "route": "cuda", "source": "nbody_tpu_torch/csrc/p2p_leaf.cu",
         "replaces": "nbody_tpu/ops/pallas_p2p.py:30",
         "launches": bh["launches"] + fmm["launches"],
         "launches_by_path": {"barnes_hut": bh["launches"],
                              "fmm": fmm["launches"]},
         "max_abs_err": k6["max_abs_err"],
         "ms": bh["k6_ms"], "plain_ms": bh["k6_plain_ms"],
         "timed_at": "one launch of the path, N=1e6 2D theta=0.25, every "
                     "leaf, fp32, kernel only",
         "real_pairs": bh["k6_pairs"],
         "ms_by_shape": {key: row["k6_one_launch"]
                         for key, row in bh["times"].items()},
         "real_pairs_by_shape": {key: row["k6_pairs"]
                                 for key, row in bh["times"].items()},
         "near_ms_per_eval": bh_t["near"],
         "near_plain_ms_per_eval": bh_t["near_plain"],
         "launches_per_eval": bh_t["k6_launches"],
         "wrapper_ms": bh["window_wrapper_ms"],
         "window_kernel_ms": bh["window_ms"],
         "window_shape": bh["window_shape"],
         "fmm_p2p_ms_by_shape": {key: row["p2p_k6"]
                                 for key, row in fmm["times"].items()},
         "fmm_real_pairs_by_shape": {key: row["k6_pairs"]
                                     for key, row in fmm["times"].items()},
         **bounds["K6"], "library_ms": None},
        {"name": "P rate probe (dependent op loop)", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/rate_probe.cu",
         "replaces": "tools/vpu_microbench.py:36",
         "launches": pr["launches"]["rate_probe"],
         "max_abs_err": pr["fma"]["max_abs_err"], "ms": pr["fma"]["ms"],
         "plain_ms": pr["fma"]["plain_ms"],
         "timed_at": f"f32 fma, (256, 1024) block, {PROBE_ITERS_TIMED} "
                     "iterations, one launch timed alone",
         "ms_run_of_10": pr["fma"]["ms_run_of_10"],
         "rates_per_s": {k: v["rate"] for k, v in pr["rates"]["ops"].items()},
         "fma_rate_per_s": pr["fma"]["rate"],
         "fma_rate_per_s_run_of_10": pr["fma"]["rate_run_of_10"],
         "ptxas": {k: v for k, v in ptxas.items()
                   if k.startswith("rate_probe")},
         **p_bounds["rate"], "library_ms": None},
        {"name": "P matmul probe (skinny fp32 SIMT GEMM, tiles in shared "
                 "memory)", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/rate_probe.cu",
         "replaces": "tools/vpu_microbench.py:96",
         "launches": pr["launches"]["matmul_probe"],
         "max_abs_err": mm[128]["max_abs_err"], "ms": mm[128]["ms"],
         "plain_ms": mm[128]["plain_ms"],
         "timed_at": f"({mm_m}, {mm_s}) @ ({mm_s}, 128) x {mb.MATMUL_REPS} "
                     "fp32",
         "ms_k4": mm[4]["ms"], "plain_ms_k4": mm[4]["plain_ms"],
         "library_ms_k4": mm[4]["library_ms"],
         "max_abs_err_k4": mm[4]["max_abs_err"],
         "bound_ms_k4": p_bounds[4]["bound_ms"],
         "library_tf32_ms": pr["rates"]["matmul"][128]["matmul_tf32_ms"],
         **p_bounds[128], "library_ms": mm[128]["library_ms"]},
    ]
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs one CUDA device", file=sys.stderr)
        return 1

    from nbody_tpu_torch import GravityConfig, Simulation
    from nbody_tpu_torch import cli
    from nbody_tpu_torch.integrators import leapfrog_step
    from nbody_tpu_torch.ops import cuda_brute as cb
    from nbody_tpu_torch.ops.brute_force import brute_force_blocked
    from nbody_tpu_torch.state import plummer_system, random_system
    from nbody_tpu_torch.utils import cuda_build

    # K5's plain version is a matmul: it must run in full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. Device.
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"[1] nvidia-smi: {smi}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")

    # 2. Build.
    t0 = time.perf_counter()
    cuda_build.load_library()
    lib_path = cuda_build.library_path()
    print(f"[2] kernels built/loaded in {time.perf_counter() - t0:.1f} s: "
          f"{lib_path.name}; flags {' '.join(cuda_build.NVCC_FLAGS)}")
    log = lib_path.with_suffix(".log").read_text()
    for line in log.splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("    " + line.strip())
    # K1 and K3's kernels (the Newton-3 engine and K1's diagonal blocks),
    # K4's cluster kernels, K6's two entries and P's kernels: registers and
    # spills from the ptxas report; a spill fails the run.
    ptxas = {cuda_build.kernel_label(k): v
             for k, v in cuda_build.ptxas_report(log).items()
             if re.search(r"newton3_kernel|diagonal_kernel|fused_steps_kernel"
                          r"|near_field_kernel|p2p_window_kernel"
                          r"|matmul_\w+_kernel|rate_probe_\w+", k)}
    for label, rep in sorted(ptxas.items()):
        print(f"    {label}: {rep}")
        if rep.get("spill_stores") or rep.get("spill_loads"):
            raise AssertionError(f"{label} spills: {rep}")
    families = {"newton3_kernel": 8, "diagonal_kernel": 4,
                "fused_steps_kernel": 16, "rate_probe": 10}
    found = {f: sum(k.startswith(f) for k in ptxas) for f in families}
    if found != families or len(ptxas) != 45:
        raise AssertionError(f"kernels in the ptxas report: {sorted(ptxas)}")

    gen = torch.Generator().manual_seed(SEED)
    default = GravityConfig()
    unit0 = GravityConfig(G=1.0, softening=0.0)

    # (label, positions f32, masses f32, config) on the card; both kernels
    # see the same draws.
    s1 = random_system(4096, 3, generator=gen, device=dev)
    s2 = random_system(100_003, 2, generator=gen, device=dev)
    p3, m3 = coincident_set(4099, gen, dev)
    sets = [("N=4096 3D", s1.positions, s1.masses, default),
            ("N=100003 2D ragged", s2.positions, s2.masses, default),
            ("N=4099 3D softening=0 coincident", p3, m3, unit0)]

    # 3. K2 against its plain version.
    print("[3] K2 precise kernel vs f64 plain version")
    for label, pos, mass, cfg in sets:
        got = cb.brute_force_cuda(pos, mass, cfg, mode="precise")
        check_close(label, got, oracle64(cb, pos, mass, cfg))
    plum = plummer_system(SIM_N, 3, generator=gen, device=dev)
    unit = GravityConfig(G=1.0, softening=0.1)
    rows = torch.randperm(SIM_N, generator=gen)[:4096].to(dev)
    got = cb.brute_force_cuda(plum.positions, plum.masses, unit,
                              mode="precise")
    k2_err = check_close(f"main-path shape N={SIM_N} 3D Plummer, 4096 rows",
                         got[rows], oracle64(cb, plum.positions, plum.masses,
                                             unit, rows))

    # 4. K1 against its plain version.
    print("[4] K1 symmetric kernel vs f64 plain version (block pairs)")
    extra = [random_system(5000, 3, generator=gen, device=dev),
             random_system(3000, 2, generator=gen, device=dev)]
    k1_sets = sets + [("N=5000 3D", extra[0].positions, extra[0].masses,
                       default),
                      ("N=3000 2D", extra[1].positions, extra[1].masses,
                       default)]
    for dim in (2, 3):
        for n in K1_EDGE_N:
            b = random_system(n, dim, generator=gen, device=dev)
            p0, m0 = coincident_set(n, gen, dev)
            k1_sets += [(f"N={n} {dim}D", b.positions, b.masses, default),
                        (f"N={n} {dim}D softening=0 coincident",
                         p0[:, :dim].contiguous(), m0, unit0)]
    for label, pos, mass, cfg in k1_sets:
        nb = -(-pos.shape[0] // cb.SYM_BLOCK)
        got = cb.brute_force_cuda(pos, mass, cfg, mode="symmetric")
        want = cb.symmetric_forces_plain(pos.double(), mass.double(), cfg)
        parity = "odd" if nb % 2 else "even"
        check_close(f"{label} [{nb} blocks, {parity}]", got, want)
    head = random_system(HEADLINE_N, 2, generator=gen, device=dev)
    rows = torch.randperm(HEADLINE_N, generator=gen)[:2048].to(dev)
    got = cb.brute_force_cuda(head.positions, head.masses, default,
                              mode="symmetric")
    k1_err = check_close(f"headline N={HEADLINE_N} 2D, 2048 sampled rows vs "
                         "one-sided f64 sum over all sources",
                         got[rows], oracle64(cb, head.positions, head.masses,
                                             default, rows))
    del got, head

    # 5-6. The main path, counted.
    reset_launches()
    print(f"[5] Simulation(method='brute').run(steps=3, dt=1e-3), "
          f"N={SIM_N} 3D Plummer, G=1, softening=0.1")
    t0 = time.perf_counter()
    sim = Simulation.create(plum, unit, method="brute").run(steps=3, dt=1e-3)
    torch.cuda.synchronize()
    print(f"    ran in {time.perf_counter() - t0:.2f} s; K2 launches "
          f"{counts()['precise']}")
    if counts()["precise"] != 2 * 3:
        raise AssertionError(f"K2 launches {counts()['precise']} != 6")
    plain_fn = lambda p, m: brute_force_blocked(p, m, unit)  # noqa: E731
    ref = plum
    for _ in range(3):
        ref = leapfrog_step(ref, plain_fn, 1e-3)
    # Both runs are fp32 and differ only in summation order: accelerations
    # agree within FORCE_TOL (scale-normalized), and from a cold start the
    # velocities are sums of them, so they are held to the same bound.
    # Positions move by ~1e-6 of their size in 3 steps and must agree to
    # 1e-5 of the largest coordinate.
    check_states("3 steps vs plain blocked path on the card",
                 (sim.system.positions, sim.system.velocities),
                 (ref.positions, ref.velocities))
    with tempfile.TemporaryDirectory() as tmp:
        sim.save(tmp)
        back = Simulation.load(tmp, unit, device=dev)
        if back.step_count != 3 or not torch.equal(back.system.positions,
                                                   sim.system.positions):
            raise AssertionError("checkpoint round trip changed the state")
    print("  save/load round trip: identical state, step 3")

    print(f"[6] CLI: -d 2 -N {HEADLINE_N} -m a --no-files --device cuda")
    before = counts()["symmetric"]
    rc = cli.main(["-d", "2", "-N", str(HEADLINE_N), "-m", "a", "--no-files",
                   "--device", "cuda"])
    if rc != 0 or counts()["symmetric"] <= before:
        raise AssertionError(f"CLI rc {rc}, K1 launches "
                             f"{counts()['symmetric'] - before}")
    print("[6] CLI: -d 2 -N 20000 -a 1 -m a --no-files --device cuda")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-d", "2", "-N", "20000", "-a", "1", "-m", "a",
                       "--no-files", "--device", "cuda"])
    print(buf.getvalue(), end="")
    m = re.search(r"BruteForce_CUDA accuracy: .*\(norm err ([0-9.e+-]+)",
                  buf.getvalue())
    if rc != 0 or m is None or not float(m.group(1)) < FORCE_TOL:
        raise AssertionError(f"CLI accuracy run: rc {rc}, match {m}")
    launches = dict(counts())
    print(f"    main-path launches: {launches}")
    if min(launches["precise"], launches["symmetric"]) == 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    # Each later phase draws from its own seed, independent of the above.
    t = phase_times(cb, seeded(7), dev, default, smi)
    k3 = phase_sym_tile(cb, seeded(8), dev, default)
    k4 = phase_fused(cb, seeded(9), dev)
    k5 = phase_mxu(cb, seeded(10), dev, default)
    k6 = phase_p2p(seeded(11), dev, default)
    bh = phase_bh(cb, seeded(12), dev, default, smi)
    pr = phase_probe(cb, seeded(13), dev, smi)
    fmm = phase_fmm(cb, seeded(14), dev, default, smi)
    phase_sparse(cb, seeded(15), dev, default, smi)

    kernels = kernels_line(t, launches, k1_err, k2_err, k3, k4, k5, k6, bh,
                           fmm, pr, ptxas)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
