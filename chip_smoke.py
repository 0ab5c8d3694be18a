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

* the main path, ``Simulation(method="brute")`` at N = 262,144 (K1) and
  8192 (K2: below ``K1_MIN_N`` the route takes the one-sided kernel), and
  the benchmark CLI at N = 2^20 (K1);
* K3's cross tiles against its plain version, one launch a tile at any
  size, the ring cell's 1.25e6 x 1.25e6 2D tile among them;
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
  sparse Barnes-Hut layout beside the dense one at 1e6 2D;
* the Hilbert radix BVH tier (plain torch, no kernel launch on its path),
  ``Simulation(method="bvh")`` at N = 1e6 2D, the CLI ``-m h`` at 1e5 3D,
  one evaluation at 5e6 2D and the Plummer input with ``caps_state``
  (escalation), against the f64 oracle; its f64 path on the card against
  the CPU's; its phase times;
* the multi-device tiers (``nbody_tpu_torch.parallel``) on a mesh of 4
  virtual shards of the card: the Newton-3 ring at N = 2^20 2D (K2 on the
  self blocks, K3 on the forward tiles), odd and even P, the one-sided
  ring, the sharded Barnes-Hut (1e6 2D) and FMM (1e5 3D)
  with K6 once a shard, the sharded BVH (1e6 2D), each against its
  single-device run and the f64 oracle; the body-sharded LET tiers
  (Barnes-Hut 1e6 2D, FMM 1e5 3D, BVH 1e6 2D; plain torch, no kernel
  launch) against their single-device runs and the f64 oracle, timed
  beside the single-device and the replicated-sharded tiers; and the dry
  run; a mesh of the real cards too where there are several (there with
  each card's peak memory under the LET and the replicated tiers);
* the harness modules (``bench.sweep --quick``, ``bench.analysis``, the
  FMM's phase breakdown, a ``torch.profiler`` trace of one Barnes-Hut
  evaluation with its kernel launches and the device's busy share, the
  native oracle built by ``make -C native``, every scenario of
  ``models/``);
* the entry points outside the library (``nbody_tpu_torch.tools``): the
  device-step bench (K Euler steps as one CUDA graph for the brute-force
  methods, K1 among them, each graph held to as many eager steps; the
  tree adapters eager, K6), ``simulate_1m`` on a Plummer sphere (the BVH
  with ``caps_state``), the method smoke (every registered method within
  its budget, 2D and 3D), the multichip tool on virtual shards (every
  tier within its tolerance, K2 and K3 on the rings, the collective
  census);
* the repo's probes (the 12 counterparts of ``tools/`` in
  ``nbody_tpu_torch.tools``: phase splits, clustered stress, big-N
  Barnes-Hut, near-field and tuning sweeps, BVH benches, the small-N floor,
  the brute-force variants, the narrow products), each
  through its ``main`` with its record held to its gate and no row failed
  (K1-K6 and P's product launched on their probes).

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
import math
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
# Below cb.K1_MIN_N: Simulation("brute") takes K2 there ([5]).
SIM_SMALL_N = 8192
TIMED_N = 262_144
SEED = 0
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
# K3 at the tile the four-card ring cell gives it (uniform2d_5m: a shard of
# 5e6 / 4 bodies a side, 2D), checked on sampled rows of each side.
RING_TILE = 1_250_000
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
# M2L / L2L sums of 189 x 512 terms up to 17 (pairwise), the L2P sum of 512
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
# The BVH tier at the reference's BVH_Parlay rows (BASELINE.md:38-41,
# uniform random_system; reference CPU seconds): Simulation one leapfrog
# step at 1e6 2D, the CLI -m h -a 1 at 1e5 3D, one evaluation at 5e6 2D
# (far_impl resolves to "local" there), and the Plummer input of [15]
# through bvh_forces with caps_state. Each held on BH_ROWS sampled rows to
# the grid tier's theta = 0.25 bound against the f64 oracle (PERF.md § 2);
# the seeded second Plummer call to BVH_SEEDED_TOL of the first (the
# escalated groups walk with other capacities: other chunks, other sums).
# The f64 path on the card against the f64 path on the CPU at BVH_F64_N
# bodies, to 1e-12: CUDA's sort, gathers and index_put_ change no MAC
# decision. The phase split at BVH_TIMED.
BVH_SIM = (1_000_000, 2)
BVH_CLI = (100_000, 3)
BVH_BIG = (5_000_000, 2)
BVH_SEED = 1600
BVH_TOL = 1e-3
BVH_SEEDED_TOL = 1e-5
BVH_F64_N = 10_000
BVH_F64_TOL = 1e-12
BVH_TIMED = [(1_000_000, 2), (100_000, 3)]
BVH_PARLAY_S = {(100_000, 2): 0.256, (100_000, 3): 1.659,
                (1_000_000, 2): 9.72, (5_000_000, 2): 67.75}
# [17] The multi-device tiers (parallel/) on MULTI_SHARDS virtual shards of
# the card (one process; the device repeated in the mesh, as the JAX tests
# repeat CPU devices), at the single-device phases' shapes: the Newton-3
# ring at HEADLINE_N 2D against the f64 sum and K1 (K2 one launch per self
# block, K3 one per forward tile, the even-P half step's pairs split
# between their two shards, half a tile each); odd and even P on RING_SMALL
# (N, P), 3D, a ragged N among them; the one-sided ring at TIMED_N 3D;
# the sharded tiers against their unsharded runs and the f64
# oracle at [12] / [14] / [16]'s gates; the dry run with the JAX package's
# gates; a mesh of real cards (at most MULTI_REAL_MAX) where there are
# several.
MULTI_SHARDS = 4
MULTI_REAL_MAX = 4
MULTI_SEED = 1800
RING_SMALL = [(5000, 2), (5000, 3), (5000, 8), (4999, 3)]
SHARDED_BH = (1_000_000, 2, 0.25)
SHARDED_FMM = (100_000, 3)
# The f64 sharded FMM against the f64 unsharded one: M2L's row chunks are
# cuBLAS products of other shapes, rounded otherwise in f64, and L2P's
# cancellation (term sums up to ~1e4 times the force, see FMM_FAR_ULPS)
# can raise that to ~1e-12 of the RMS force.
FMM_SHARDED_F64_TOL = 1e-10
SHARDED_BVH = (1_000_000, 2, 0.25)
# [17] The body-sharded LET tiers at the sizes their users run, uniform
# fp32, on the same mesh: Barnes-Hut (n, dim, theta) with its default
# local far field, the FMM (n, dim) at FMM_ORDER, the BVH (n, dim, theta).
LET_BH = (1_000_000, 2, 0.25)
LET_FMM = (100_000, 3)
LET_BVH = (1_000_000, 2, 0.25)
# [18] The harness modules on the card: the quick sweep (every registered
# tier at 1e3 and 1e4, 2D and 3D, with accuracy), the FMM's phase
# breakdown at HARNESS_FMM, one traced Barnes-Hut evaluation at TRACE_BH,
# the native oracle against the f64 brute force at NATIVE_N 2D, and every
# scenario of models/.
HARNESS_SEED = 1900
HARNESS_FMM = (100_000, 3)
TRACE_BH = (1_000_000, 2, 0.25)
NATIVE_N = 20_000
# The native oracle and the port's f64 brute force sum the same f64 terms
# in other orders: far below this scale-normalized bound.
NATIVE_TOL = 1e-10
# [19] The entry points outside the library (nbody_tpu_torch.tools): the
# device-step bench's graph rows at STEP_N (2D, 3D; runs a K:
# STEP_REPEATS), each graph of STEP_CHECK_K Euler steps held to as many
# eager steps on G = 1 Plummer bodies (dt STEP_DT: they move), K1 to
# STEP_K1_REL (its fp64 atomics add in no fixed order), the plain path bit
# for bit; every tree adapter once at STEP_TREE, eager; simulate_1m at
# SIM1M_N, SIM1M_STEPS steps; the method smoke at SMOKE_N, 2D and 3D; the
# multichip tool at MULTI_TOOL_N on MULTI_TOOL_P virtual shards.
ENTRY_SEED = 2000
STEP_N = [1000, 100_000]
STEP_REPEATS = [3, 1]
STEP_CHECK_K = 4
STEP_DT = 1e-3
STEP_K1_REL = 1e-5
STEP_TREE = (100_000, 3)
SIM1M_N = 262_144
SIM1M_STEPS = 3
SMOKE_N = 20_000
MULTI_TOOL_N = 4096
MULTI_TOOL_P = "2,4"
# [20] The repo's probes (nbody_tpu_torch.tools), each through its
# main(argv) with the launch counts set to 0 just before it and read just
# after: (module, argv, the kernels it must launch). Where the JAX tool's
# default run is short it runs as is; clustered_phase, bh_bigN_probe,
# bvh_bench and bvh_far_flip_probe are cut in depth. Their gates:
# PROBE_TOL, the grid tier's theta = 0.25 gate of PERF.md section 2, on
# clustered_stress's two sampled errors and local_leaf_check's point and
# hier errors; each K6 row of bh_near_probe within twice K6_ULPS of the
# plain row's largest force (both are fp32); brute_variants' checksums
# within PROBE_CHECKSUM_REL of the blocked oracle's, K5's rows within
# PROBE_CHECKSUM_REL_MXU, the JAX package's bound for its sorted form
# (tests/test_pallas_brute.py:131; its cancellation biases the sum: the
# mxu rows read 0.90-1.01e-4 at 2^20 2D on the H100, K1 and K2 0); P's
# product within MATMUL_TOL of its f64 sum; smalln_floor's K1 graph within
# STEP_K1_REL of its eager steps.
PROBES = [
    ("tree_phase_bench", ["--n", "1048576", "--dim", "2"], ("near_field",)),
    ("tree_phase_bench", ["--n", "1048576", "--dim", "2", "--fmm"], ()),
    ("clustered_stress", ["--n", "100000"], ()),
    ("clustered_phase", ["--n", "100000"], ()),
    ("bh_bigN_probe", ["--cases", "2000000:2"], ("near_field",)),
    ("bh_near_probe", ["--n", "100000", "--dim", "3", "--impls",
                       "plain,cuda"], ("near_field",)),
    ("bh_tune", ["--n", "100000", "--dim", "2"], ("near_field",)),
    ("bvh_bench", ["--cases", "100000:2,100000:3"], ()),
    ("bvh_far_flip_probe", ["--cases", "200000:2,200000:3", "--samples",
                            "256"], ()),
    ("local_leaf_check", ["-N", "20000", "--dim", "3", "--time"],
     ("near_field",)),
    ("smalln_floor", ["--n", "1000", "--dim", "2"],
     ("symmetric", "fused_steps")),
    ("brute_variants", ["--n", "1048576", "--dim", "2"],
     ("precise", "symmetric", "mxu")),
    ("mxu_narrow_bench", [], ("matmul_probe",)),
]
PROBE_TOL = 1e-3
PROBE_CHECKSUM_REL = 1e-4
PROBE_CHECKSUM_REL_MXU = 3e-4
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
    """[8] K3 against its plain version, one launch a tile, counted."""
    from nbody_tpu_torch.state import random_system
    print("[8] K3 sym tile vs f64 plain version (both outputs)")
    errs = []
    reset_launches()
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
    bodies = random_system(2 * RING_TILE, 2, generator=gen, device=dev)
    tp, sp = bodies.positions[:RING_TILE], bodies.positions[RING_TILE:]
    tm, sm = bodies.masses[:RING_TILE], bodies.masses[RING_TILE:]
    got = cb.sym_tile_cuda(tp, tm, sp, sm, default.softening)
    tp, tm, sp, sm = (x.double() for x in (tp, tm, sp, sm))
    for side, g, (a, am, b, bm) in zip(("acc_t", "part_s"), got,
                                       ((tp, tm, sp, sm), (sp, sm, tp, tm))):
        rows = sample_rows(RING_TILE, gen, dev)
        w = cb.sym_tile_plain(a[rows], am[rows], b, bm, default.softening)[0]
        errs.append(check_close(
            f"{RING_TILE}x{RING_TILE} 2D {side}, {SAMPLED_ROWS} sampled rows "
            "vs f64 sum", g[rows], w, tol=max(FORCE_TOL, fp32_floor(w))))
    del got, bodies, tp, tm, sp, sm
    launches = dict(counts())
    expect_launches(f"{len(SYM_TILE_PAIRS) + 1} tiles", launches,
                    {"sym_tile": len(SYM_TILE_PAIRS) + 1})
    return {"launches": launches["sym_tile"], "max_abs_err": max(errs)}


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
        # Leapfrog's F(x0) and F(x1), the later steps' F(x0) carried.
        want = (1 + BH_STEPS) * rp["num_segments"]
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
                      tree64.num_leaf_cells)
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


def fmm_fp32_check(label, got, single, pos, mass, cfg, order) -> None:
    """Hold an fp32 FMM run ``got`` to the single-device fp32 run
    ``single`` per body: within twice each body's far allowance
    (:func:`fmm_far_allowance`, on the f64 copy of the tree) plus twice
    K6's fp32 floor of the f64 run."""
    from nbody_tpu_torch.ops import fmm as fm, grid_tree as gt
    n, dim = pos.shape
    L = gt.auto_leaf_level(n, dim)
    tree = gt.build_grid_tree(pos, mass, L, gt.compute_capacity(pos, L))
    t64 = tree_f64(gt, tree)
    gm = (cfg.G * mass.double())[:, None]
    a_sh = (got.double() / gm)[tree.order]
    a_un = (single.double() / gm)[tree.order]
    a64 = fm.fmm_accel_sorted(t64, order=order, softening=cfg.softening)
    rms = float(a64.norm(dim=-1).pow(2).mean().sqrt())
    near_tol = max(1e-5, fp32_floor(a64, K6_ULPS))
    far = fmm_far_allowance(fm, t64, order)
    excess = float(((a_sh - a_un).norm(dim=-1) - 2 * far).max()) / rms
    finite = bool(torch.isfinite(got).all())
    print(f"    {label} fp32 vs fmm_forces fp32, per body: "
          f"{float((a_sh - a_un).norm(dim=-1).max()) / rms:.3e} of the RMS; "
          f"beyond twice each body's far allowance {excess:.3e} (tol twice "
          f"the near floor {2 * near_tol:.3e}), finite {finite}")
    if not (finite and excess <= 2 * near_tol):
        raise AssertionError(f"{label} fp32: {excess} > {2 * near_tol}")


def fmm_phase_times(fm, gt, cuda_p2p, pos, mass, cfg, order) -> dict:
    """CUDA-event times (1 warm-up, median of 3) of one fp32 evaluation and
    of its phases on its own tree; the M2L's operations and FLOP bound."""
    n, dim = pos.shape
    L = gt.auto_leaf_level(n, dim)
    tree = gt.build_grid_tree(pos, mass, L, gt.compute_capacity(pos, L))
    Tt, m2m = fm._tables(dim, order, pos.dtype, pos.device)
    # The local side's tables (L2L, L2P) in its own dtype.
    Tt_l, m2m_l = fm._tables(dim, order, fm._LOCAL_DTYPE, pos.device)
    nl = tree.num_leaf_cells
    W = fm._m2m(fm._p2m_dense(tree, order, 1024, Tt), m2m, dim, L)
    Lc = fm._m2l(tree, W, order, 1)
    nD = order ** dim
    # The products M2L makes: each cell's parity class's offsets.
    per_cell = fm._v_list_tables(dim, 1, order, pos.device)[1].shape[1]
    m2l_flops = sum(2 * (1 << (dim * l)) * per_cell * nD * nD
                    for l in range(2, L + 1))
    row = {
        "eval": time_ms(lambda: fm.fmm_forces(pos, mass, cfg, order=order)),
        "build": time_ms(lambda: gt.build_grid_tree(
            pos, mass, L, gt.compute_capacity(pos, L))),
        "p2m_m2m": time_ms(lambda: fm._m2m(
            fm._p2m_dense(tree, order, 1024, Tt), m2m, dim, L)),
        "m2l": time_ms(lambda: fm._m2l(tree, W, order, 1)),
        "l2l_l2p": time_ms(lambda: fm._l2p(
            tree, fm._l2l(dict(Lc), m2m_l, L, nl), order, Tt_l)),
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
    Barnes-Hut theta = 0.25 under layout="auto" takes its sparse layout (no
    K6 launch) and the FMM its occupied-cell layout (one launch of K6's
    occupied-leaf entry), against the f64 oracle; K6's occupied-leaf entry
    alone against its plain version on the FMM's tree at leaf level 10 and
    on the same bodies with a collapsed core (one leaf of thousands of
    bodies); then the sparse Barnes-Hut layout beside the dense one on
    uniform bodies."""
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
    real_occ = sg.build_occupied_tree

    def bh_counted(*a, **k):
        calls.append("barnes_hut_sparse")
        return real_bh(*a, **k)

    def stats_counted(*a, **k):
        calls.append("sparse_grid_stats")
        return real_stats(*a, **k)

    def occ_counted(*a, **k):
        calls.append("build_occupied_tree")
        return real_occ(*a, **k)

    rp = gt.resolve_bh_params(n, 3, 0.25)
    for name, fn, L, tol, route, launches in (
            ("barnes_hut_grid theta=0.25", lambda: gt.barnes_hut_grid(
                pos, mass, cfg, theta=0.25), rp["leaf_level"], SPARSE_BH_TOL,
             "sparse_grid_stats", {"near_field": 0, "p2p_leaf": 0}),
            (f"fmm_forces order={FMM_ORDER}", lambda: fm.fmm_forces(
                pos, mass, cfg, order=FMM_ORDER), gt.auto_leaf_level(n, 3),
             FMM_GATE, "build_occupied_tree",
             {"near_field": 0, "p2p_leaf": 0, "near_field_occupied": 1})):
        cap = gt.compute_capacity(pos, L)
        if not gt.dense_layout_degenerate(cap, n, L, 3):
            raise AssertionError(f"{name}: capacity {cap} at L={L} is not "
                                 "degenerate")
        calls.clear()
        sg.barnes_hut_sparse, sg.sparse_grid_stats = bh_counted, stats_counted
        sg.build_occupied_tree = occ_counted
        reset_launches()
        try:
            got = fn()
            torch.cuda.synchronize()
        finally:
            sg.barnes_hut_sparse, sg.sparse_grid_stats = real_bh, real_stats
            sg.build_occupied_tree = real_occ
        print(f"    {name}: leaf level {L}, densest leaf {cap} bodies; "
              f"layout calls {calls}")
        if route not in calls:
            raise AssertionError(f"{name} did not call {route}")
        expect_launches(name, counts(), launches)
        out["occupied_launches"] = out.get("occupied_launches", 0) + counts()[
            "near_field_occupied"]
        err = check_close(f"{name} vs f64 oracle, {rows.numel()} sampled "
                          "rows", got[rows], want, tol=tol)
        ms = time_ms(fn)
        print(f"    {name}: {ms:.3f} ms an evaluation (capacity probe and "
              f"{route}'s probe included; CUDA events, 1 warm-up, median of "
              f"3), {smi}")
        out[name] = {"ms": ms, "max_abs_err": err, "err": float(
            scale_normalized_error(got[rows].double(), want))}
        del got
    out["k6_occupied"] = occupied_k6_check(pos, mass, cfg, smi)
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


def occupied_k6_check(pos, mass, cfg, smi) -> dict:
    """[15]'s check of K6's occupied-leaf entry (``near_field_occupied_cuda``,
    one launch) against its plain version on the same tree in f64, at
    ``K6_ULPS``: on the Plummer bodies' tree at leaf level 10 (the FMM
    cell's), and on the same bodies with their 5,000 innermost moved into
    one leaf of that level, as the cell's cold core collapses. Each with
    its real pairs, its time (the entry, wrapper included; CUDA events, 1
    warm-up, median of 3) and the bound of 21 operations a pair at the
    fp32 peak."""
    import dataclasses
    from nbody_tpu_torch.ops import cuda_p2p, grid_tree as gt
    from nbody_tpu_torch.ops import sparse_grid as sg
    n, dim = pos.shape
    level = 10
    lo, hi = gt.domain_bounds(pos)
    side = (hi - lo) / (1 << level)
    core = pos.norm(dim=-1).argsort()[:5000]
    mid = pos[core].mean(0)
    center = lo + (torch.floor((mid - lo) / side) + 0.5) * side
    spread = (pos[core] - mid).abs().max()
    collapsed = pos.clone()
    collapsed[core] = center + (pos[core] - mid) * (0.25 * side.min()
                                                    / spread)
    out = {}
    for name, p in (("plummer_L10", pos), ("collapsed_L10", collapsed)):
        t32 = sg.build_occupied_tree(p, mass, level)
        t64 = dataclasses.replace(t32, **{
            f.name: getattr(t32, f.name).double()
            for f in dataclasses.fields(t32)
            if torch.is_tensor(getattr(t32, f.name))
            and getattr(t32, f.name).is_floating_point()})
        table = sg.occupied_ring_table(t32, 1)
        fullest = int(t32.leaf_count.max())
        if name == "collapsed_L10" and fullest <= 1000:
            raise AssertionError(f"{name}: fullest leaf {fullest} bodies")
        reset_launches()
        got = cuda_p2p.near_field_occupied_cuda(t32, table, cfg.softening)
        torch.cuda.synchronize()
        expect_launches(name, counts(), {"near_field_occupied": 1,
                                         "near_field": 0, "p2p_leaf": 0})
        want = cuda_p2p.near_field_occupied_plain(t64, table, cfg.softening)
        err = check_close(f"K6 occupied-leaf entry, {name} ({t32.num_leaves}"
                          f" leaves, fullest {fullest}) vs f64 plain",
                          got, want,
                          tol=max(1e-5, fp32_floor(want, K6_ULPS)))
        pairs = int(sg.occupied_ring_pairs(t32, table))
        ms = time_ms(lambda: cuda_p2p.near_field_occupied_cuda(
            t32, table, cfg.softening))
        b = bound(21 * pairs, n * (16 + 4 * dim) + table.numel() * 8, pairs)
        print(f"    K6 occupied-leaf entry, {name}: {ms:.3f} ms, {pairs} real "
              f"pairs, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
              f"{smi}")
        out[name] = {"ms": ms, "max_abs_err": err, "real_pairs": pairs,
                     "fullest_leaf": fullest, "leaves": t32.num_leaves, **b}
        del got, want, t32, t64, table
    return out


def bvh_phase_split(bvh, pos, mass, cfg, smi) -> dict:
    """The BVH evaluation's phases at bvh_forces's defaults (CUDA events, 1
    warm-up, median of 3): the build, the walk without pass 2, pass 2 (the
    walk less that), the whole evaluation; its host read-backs and peak
    memory."""
    n, dim = pos.shape
    kb = dim * bvh.MAX_BITS[dim]
    walk = dict(leaf_size=16, theta=cfg.theta, softening=cfg.softening,
                group_size=min(1024, n), batch=128, multipole="quad",
                far_impl=bvh.resolve_bvh_far_impl(n))
    tree = bvh.build_bvh(pos, mass, kb, quad=True)
    t = {"build": time_ms(lambda: bvh.build_bvh(pos, mass, kb, quad=True)),
         "walk_no_near": time_ms(lambda: bvh.bvh_accel_sorted(
             tree, **walk, _debug_skip="near")),
         "walk": time_ms(lambda: bvh.bvh_accel_sorted(tree, **walk)),
         "eval": time_ms(lambda: bvh.bvh_forces(pos, mass, cfg))}
    t["near"] = t["walk"] - t["walk_no_near"]
    del tree
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bvh.HOST_READS["count"] = 0
    bvh.bvh_forces(pos, mass, cfg)
    torch.cuda.synchronize()
    t["host_reads"] = bvh.HOST_READS["count"]
    t["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    ref = BVH_PARLAY_S.get((n, dim))
    print(f"    BVH phases N={n} {dim}D: build {t['build']:.3f} ms, walk "
          f"without pass 2 {t['walk_no_near']:.3f} ms, pass 2 "
          f"{t['near']:.3f} ms, evaluation {t['eval']:.3f} ms; "
          f"{t['host_reads']} host read-backs, peak {t['peak_gib']:.3f} GiB "
          f"above the bodies; reference BVH_Parlay "
          f"{'%g s' % ref if ref else 'none'}; {smi}")
    return t


def phase_bvh(cb, dev, default, smi, sparse) -> dict:
    """[16] The BVH tier on the card, plain torch: Simulation('bvh'), the
    CLI -m h, 5e6 2D, Plummer with caps_state against [15]'s sparse grid,
    the f64 path against the CPU's, and the phase split. No kernel of K1-K6
    is on its path; the only launches in the phase are K1's as the CLI's
    accuracy reference."""
    from nbody_tpu_torch import GravityConfig, Simulation, cli
    from nbody_tpu_torch.ops import bvh
    from nbody_tpu_torch.state import plummer_system, random_system
    from nbody_tpu_torch.utils.accuracy import scale_normalized_error
    t_phase = time.perf_counter()
    out = {}
    print("[16] BVH tier: Simulation('bvh'), CLI -m h, 5e6 2D, Plummer "
          "caps_state, f64 CUDA vs CPU, phase split")
    reset_launches()

    def draw(n, dim, seed):
        bodies = random_system(n, dim, generator=torch.Generator()
                               .manual_seed(seed), device=dev)
        rows = torch.randperm(n, generator=torch.Generator().manual_seed(
            seed + 1))[:BH_ROWS].to(dev)
        return bodies, rows

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    # 1. Simulation('bvh'): one evaluation held, then one leapfrog step.
    n, dim = BVH_SIM
    bodies, rows = draw(n, dim, BVH_SEED)
    pos, mass = bodies.positions, bodies.masses
    sim = Simulation.create(bodies, default, method="bvh")
    got, ms = timed(sim.forces)
    want = oracle64(cb, pos, mass, default, rows)
    out["sim_err"] = check_close(
        f"Simulation('bvh') N={n} {dim}D one evaluation ({ms:.3f} ms), "
        f"{rows.numel()} sampled rows vs f64 oracle", got[rows], want,
        tol=BVH_TOL)
    t0 = time.perf_counter()
    sim = sim.run(steps=1, dt=1e-3)
    torch.cuda.synchronize()
    print(f"    Simulation('bvh').run(steps=1): {time.perf_counter() - t0:.2f}"
          " s (two evaluations)")
    if not (sim.step_count == 1
            and bool(torch.isfinite(sim.system.positions).all())
            and bool(torch.isfinite(sim.system.velocities).all())):
        raise AssertionError("Simulation('bvh') state not finite")
    # ADVICE: accuracy comparisons pin far_impl. At 1e6 the Simulation's
    # evaluation was "point".
    if bvh.resolve_bvh_far_impl(n) != "point":
        raise AssertionError(f"far_impl at N={n} is not 'point'")
    for impl in ("point", "local"):
        if impl == "local":
            got = bvh.bvh_forces(pos, mass, default, far_impl=impl)
        err = float(scale_normalized_error(got[rows].double(), want))
        print(f"    far_impl={impl!r} at N={n} {dim}D: {err:.3e} vs the f64 "
              "oracle on the same rows (printed)")
        out[f"err_{impl}"] = err
    del sim, got, bodies, pos, mass

    # 2. The CLI, its accuracy against its own reference (K1).
    n, dim = BVH_CLI
    args = ["-d", str(dim), "-N", str(n), "-m", "h", "-a", "1", "--no-files",
            "--device", "cuda"]
    print(f"    CLI: {' '.join(args)}")
    k1_before = counts()["symmetric"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    print(buf.getvalue(), end="")
    k1_cli = counts()["symmetric"] - k1_before
    m = re.search(r"BVH_Radix accuracy: ([0-9.]+)% \(norm err ([0-9.e+-]+)",
                  buf.getvalue())
    print(f"    BVH_Radix vs BruteForce_CUDA: {m.groups() if m else None} "
          f"(norm err tol {BVH_TOL:g}); K1 launches for the reference "
          f"(warm-up and timed): {k1_cli}")
    if rc != 0 or m is None or not float(m.group(2)) < BVH_TOL \
            or k1_cli != 2:
        raise AssertionError(f"CLI -m h: rc {rc}, match {m}, K1 {k1_cli}")

    # 3. One evaluation at 5e6 2D, far_impl resolved to "local".
    n, dim = BVH_BIG
    bodies, rows = draw(n, dim, BVH_SEED + 2)
    pos, mass = bodies.positions, bodies.masses
    if bvh.resolve_bvh_far_impl(n) != "local":
        raise AssertionError("far_impl at 5e6 is not 'local'")
    got, ms = timed(lambda: bvh.bvh_forces(pos, mass, default))
    out["big_ms"] = ms
    out["big_err"] = check_close(
        f"bvh_forces N={n} {dim}D far_impl='local' ({ms:.3f} ms, reference "
        f"BVH_Parlay {BVH_PARLAY_S[(n, dim)]} s), {rows.numel()} sampled "
        "rows vs f64 oracle", got[rows], oracle64(cb, pos, mass, default,
                                                  rows), tol=BVH_TOL)
    del bodies, pos, mass, got

    # 4. Plummer (the bodies of [15]) with caps_state: the first call
    # escalates, the second is seeded from the dict.
    n = SPARSE_N
    cfg = GravityConfig(G=1.0, softening=4.0 / n, theta=0.25)
    bodies = plummer_system(n, 3, generator=torch.Generator().manual_seed(
        SPARSE_SEED), device=dev)
    pos, mass = bodies.positions, bodies.masses
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(
        SPARSE_SEED + 1))[:BH_ROWS].to(dev)
    caps = {}
    first, ms1 = timed(lambda: bvh.bvh_forces(pos, mass, cfg,
                                              caps_state=caps))
    print(f"    Plummer N={n} 3D (G=1, softening 4/N), theta=0.25: caps_state "
          f"after the first call {caps}")
    if set(caps) != {"w2", "nl2"} or any(
            v <= 0 or v != bvh._cap_bucket(v) for v in caps.values()):
        raise AssertionError(f"the first call did not escalate: {caps}")
    out["plummer_err"] = check_close(
        f"Plummer bvh_forces, {rows.numel()} sampled rows vs f64 oracle",
        first[rows], oracle64(cb, pos, mass, cfg, rows), tol=BVH_TOL)
    second, ms2 = timed(lambda: bvh.bvh_forces(pos, mass, cfg,
                                               caps_state=caps))
    check_close("Plummer second call (seeded) vs the first", second,
                first.double(), tol=BVH_SEEDED_TOL)
    sparse_ms = sparse["barnes_hut_grid theta=0.25"]["ms"]
    print(f"    Plummer bvh_forces: first call {ms1:.3f} ms, seeded second "
          f"call {ms2:.3f} ms; [15]'s sparse-grid Barnes-Hut theta=0.25 "
          f"{sparse_ms:.3f} ms on the same bodies; {smi}")
    out.update(plummer_ms=(ms1, ms2), plummer_caps=dict(caps))
    del bodies, pos, mass, first, second

    # 5. The f64 path on the card against the f64 path on the CPU.
    cfg = GravityConfig(G=1.0, softening=1e-3, theta=0.25)
    for dim in (3, 2):
        gen = torch.Generator().manual_seed(BVH_SEED + dim)
        pos = torch.rand((BVH_F64_N, dim), generator=gen, dtype=torch.float64)
        mass = 0.5 + torch.rand((BVH_F64_N,), generator=gen,
                                dtype=torch.float64)
        t0 = time.perf_counter()
        host = bvh.bvh_forces(pos, mass, cfg)
        t_cpu = time.perf_counter() - t0
        card = bvh.bvh_forces(pos.to(dev), mass.to(dev), cfg).cpu()
        diff = float((card - host).abs().max() / host.abs().max())
        print(f"    f64 N={BVH_F64_N} {dim}D: CUDA vs CPU max abs diff "
              f"{diff:.3e} of the largest force (tol {BVH_F64_TOL:g}; the "
              f"CPU path took {t_cpu:.1f} s)")
        if not diff <= BVH_F64_TOL:
            raise AssertionError(f"f64 CUDA path vs CPU path: {diff}")

    # 6. The phase split.
    for n, dim in BVH_TIMED:
        bodies = random_system(n, dim, generator=torch.Generator()
                               .manual_seed(BVH_SEED + 10 + dim), device=dev)
        out[f"{n}_{dim}d"] = bvh_phase_split(bvh, bodies.positions,
                                             bodies.masses, default, smi)
        del bodies

    launches = dict(counts())
    print(f"    launches in the phase: {launches}")
    if launches["symmetric"] != k1_cli or any(
            v for k, v in launches.items() if k != "symmetric"):
        raise AssertionError(f"a kernel ran on the BVH path: {launches}")
    print(f"    [16] took {time.perf_counter() - t_phase:.1f} s")
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

    big2e6 = random_system(2_000_000, 2, generator=gen, device=dev)
    t["K1_2e6"] = time_ms(lambda: cb.brute_force_cuda(
        big2e6.positions, big2e6.masses, default, mode="symmetric"))
    print(f"    N=2000000 2D fp32: one K1 launch {t['K1_2e6']:.3f} ms")
    del big2e6

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


def ring_k3_launches(p: int) -> int:
    """K3 launches of the Newton-3 ring on P shards: P tiles a forward
    step over ⌈(P−1)/2⌉ = P // 2 steps (at even P the last splits each
    pair's rectangle between its two shards)."""
    return p * (p // 2)


def ring_checks(ring, cb, mesh, gen, dev, default, smi) -> dict:
    """[17] parts 1-4: the rings on ``mesh``, counted and checked."""
    from nbody_tpu_torch.parallel import make_mesh
    from nbody_tpu_torch.state import random_system
    p = mesh.num_shards
    out = {}
    head = random_system(HEADLINE_N, 2, generator=gen, device=dev)
    pos, mass = head.positions, head.masses
    print(f"    Newton-3 ring, N={HEADLINE_N} 2D fp32, {p} shards")
    reset_launches()
    got = ring.ring_brute_force(pos, mass, default, mesh=mesh)
    torch.cuda.synchronize()
    want = {"precise": p, "sym_tile": ring_k3_launches(p), "symmetric": 0}
    expect_launches(f"ring N={HEADLINE_N} 2D", counts(), want)
    out["launches"] = want
    rows = sample_rows(HEADLINE_N, gen, dev)
    out["max_abs_err"] = check_close(
        f"ring N={HEADLINE_N} 2D, {SAMPLED_ROWS} sampled rows vs one-sided "
        "f64 sum", got[rows], oracle64(cb, pos, mass, default, rows))
    k1 = cb.brute_force_cuda(pos, mass, default, mode="symmetric").double()
    check_close(f"ring N={HEADLINE_N} 2D vs K1, every body (tol max("
                f"FORCE_TOL, fp32 floor {fp32_floor(k1):.3e}))", got, k1,
                tol=max(FORCE_TOL, fp32_floor(k1)))
    del k1, got
    out["ring_ms"] = time_ms(lambda: ring.ring_brute_force(
        pos, mass, default, mesh=mesh))
    out["k1_ms"] = time_ms(lambda: cb.brute_force_cuda(
        pos, mass, default, mode="symmetric"))
    print(f"    ring {out['ring_ms']:.3f} ms vs K1 {out['k1_ms']:.3f} ms "
          f"(same N, one launch pair), {smi}")
    del head, pos, mass

    print("    odd and even P, 3D, vs the f64 sum over every body")
    for n, q in RING_SMALL:
        b = random_system(n, 3, generator=gen, device=dev)
        reset_launches()
        got = ring.ring_brute_force(b.positions, b.masses, default,
                                    mesh=make_mesh([dev] * q))
        torch.cuda.synchronize()
        expect_launches(f"ring N={n} P={q}", counts(),
                        {"precise": q, "sym_tile": ring_k3_launches(q)})
        check_close(f"ring N={n} 3D P={q}", got,
                    oracle64(cb, b.positions, b.masses, default))

    b = random_system(TIMED_N, 3, generator=gen, device=dev)
    reset_launches()
    got = ring.ring_brute_force(b.positions, b.masses, default, mesh=mesh,
                                symmetric=False)
    torch.cuda.synchronize()
    expect_launches(f"one-sided ring N={TIMED_N} 3D", counts(),
                    {"precise": p * p, "sym_tile": 0})
    rows = sample_rows(TIMED_N, gen, dev)
    check_close(f"one-sided ring N={TIMED_N} 3D, {SAMPLED_ROWS} rows",
                got[rows], oracle64(cb, b.positions, b.masses, default,
                                    rows))
    out["one_sided_ms_3d"] = time_ms(lambda: ring.ring_brute_force(
        b.positions, b.masses, default, mesh=mesh, symmetric=False))

    print(f"    one-sided ring N={TIMED_N} 3D {out['one_sided_ms_3d']:.3f} "
          f"ms, {smi}")
    return out


def phase_multi(cb, dev, default, smi) -> dict:
    """[17] The multi-device tiers on MULTI_SHARDS virtual shards of the
    card: the rings through K2 and K3, the sharded Barnes-Hut and FMM (K6
    once a shard), the sharded BVH, each held to its unsharded run and the
    f64 oracle, and the dry run; then a mesh of real cards, if any."""
    from nbody_tpu_torch.config import FMM_ORDER
    from nbody_tpu_torch.ops import bvh, fmm as fm, grid_tree as gt
    from nbody_tpu_torch.parallel import dryrun, make_mesh, ring
    from nbody_tpu_torch.parallel import sharded_tree as st
    from nbody_tpu_torch.state import random_system
    from nbody_tpu_torch.utils.accuracy import scale_normalized_error
    t_phase = time.perf_counter()
    p = MULTI_SHARDS
    mesh = make_mesh([dev] * p)
    gen = torch.Generator().manual_seed(MULTI_SEED)
    print(f"[17] multi-device tiers on a mesh of {p} virtual shards of {dev} "
          "(one process), timed with CUDA events beside the single-device "
          f"runs, {smi}")
    out = {"ring": ring_checks(ring, cb, mesh, gen, dev, default, smi),
           "times": {}}

    def timed(name, sharded, single, reps=3):
        row = {"sharded_ms": time_ms(sharded, reps=reps),
               "single_ms": time_ms(single, reps=reps)}
        out["times"][name] = row
        print(f"    {name}: sharded {row['sharded_ms']:.3f} ms, "
              f"single-device {row['single_ms']:.3f} ms, {smi}")

    # Barnes-Hut, theta = 0.25 (k = 3), the far field per body as in the
    # JAX package's sharded tier: held to the unsharded tier with the same
    # far field.
    n, dim, theta = SHARDED_BH
    b = random_system(n, dim, generator=gen, device=dev)
    pos, mass = b.positions, b.masses
    one = dict(theta=theta, far_impl="point", layout="dense")
    single = gt.barnes_hut_grid(pos, mass, default, **one)
    reset_launches()
    got = st.barnes_hut_sharded(pos, mass, default, mesh=mesh, theta=theta)
    torch.cuda.synchronize()
    expect_launches(f"barnes_hut_sharded N={n} {dim}D", counts(),
                    {"near_field": p, "p2p_leaf": 0})
    out["bh_launches"] = p
    s64 = single.double()
    check_close(f"barnes_hut_sharded N={n} {dim}D theta={theta} vs "
                "barnes_hut_grid (both fp32)", got, s64,
                tol=max(1e-5, 2 * fp32_floor(s64, K6_ULPS)))
    rows = torch.randperm(n, generator=gen)[:BH_ROWS].to(dev)
    check_close(f"barnes_hut_sharded N={n} {dim}D, {BH_ROWS} rows vs f64 "
                "oracle", got[rows], oracle64(cb, pos, mass, default, rows),
                tol=1e-3)
    timed(f"barnes_hut_{n}_{dim}d_theta{theta}_point",
          lambda: st.barnes_hut_sharded(pos, mass, default, mesh=mesh,
                                        theta=theta),
          lambda: gt.barnes_hut_grid(pos, mass, default, **one))
    del b, pos, mass, single, got, s64

    # FMM, order 8: fp32 with K6, per body against the unsharded run; f64
    # against the f64 oracle and the unsharded f64 run.
    n, dim = SHARDED_FMM
    order = FMM_ORDER
    b = random_system(n, dim, generator=gen, device=dev)
    pos, mass = b.positions, b.masses
    single = fm.fmm_forces(pos, mass, default, order=order)
    reset_launches()
    got = st.fmm_sharded(pos, mass, default, mesh=mesh, order=order)
    torch.cuda.synchronize()
    expect_launches(f"fmm_sharded N={n} {dim}D", counts(),
                    {"near_field": p, "p2p_leaf": 0})
    out["fmm_launches"] = p
    fmm_fp32_check(f"fmm_sharded N={n} {dim}D", got, single, pos, mass,
                   default, order)
    rows = torch.randperm(n, generator=gen)[:BH_ROWS].to(dev)
    want = oracle64(cb, pos, mass, default, rows)
    reset_launches()
    got64 = st.fmm_sharded(pos.double(), mass.double(), default, mesh=mesh,
                           order=order)
    torch.cuda.synchronize()
    expect_launches(f"fmm_sharded N={n} {dim}D f64 ('auto': plain near)",
                    counts(), {"near_field": 0, "p2p_leaf": 0})
    check_close(f"fmm_sharded N={n} {dim}D f64, {BH_ROWS} rows vs f64 "
                "oracle", got64[rows], want, tol=FMM_GATE)
    check_close(f"fmm_sharded N={n} {dim}D f64 vs fmm_forces f64", got64,
                fm.fmm_forces(pos.double(), mass.double(), default,
                              order=order), tol=FMM_SHARDED_F64_TOL)
    timed(f"fmm_{n}_{dim}d_order{order}",
          lambda: st.fmm_sharded(pos, mass, default, mesh=mesh, order=order),
          lambda: fm.fmm_forces(pos, mass, default, order=order))
    del b, pos, mass, single, got, got64

    # BVH, theta = 0.25 quad, groups of 1024 (plain torch: no launch).
    n, dim, theta = SHARDED_BVH
    b = random_system(n, dim, generator=gen, device=dev)
    pos, mass = b.positions, b.masses
    single = bvh.bvh_forces(pos, mass, default, theta=theta)
    reset_launches()
    got = st.bvh_sharded(pos, mass, default, mesh=mesh, theta=theta)
    torch.cuda.synchronize()
    expect_launches(f"bvh_sharded N={n} {dim}D", counts(),
                    {k: 0 for k in counts()})
    s64 = single.double()
    check_close(f"bvh_sharded N={n} {dim}D theta={theta} vs bvh_forces "
                "(both fp32)", got, s64, tol=max(1e-5, fp32_floor(s64)))
    rows = torch.randperm(n, generator=gen)[:BH_ROWS].to(dev)
    check_close(f"bvh_sharded N={n} {dim}D, {BH_ROWS} rows vs f64 oracle",
                got[rows], oracle64(cb, pos, mass, default, rows),
                tol=BVH_TOL)
    timed(f"bvh_{n}_{dim}d_theta{theta}",
          lambda: st.bvh_sharded(pos, mass, default, mesh=mesh, theta=theta),
          lambda: bvh.bvh_forces(pos, mass, default, theta=theta), reps=1)
    del b, pos, mass, single, got, s64

    out["let"] = let_checks(cb, mesh, gen, dev, default, smi)

    print(f"    dryrun_multichip on {p} virtual shards")
    out["dryrun"] = dryrun.dryrun_multichip(mesh, log=lambda m: print(
        "    " + m))
    count = torch.cuda.device_count()
    if count > 1:
        real = make_mesh([torch.device("cuda", i)
                          for i in range(min(count, MULTI_REAL_MAX))])
        print(f"    a mesh of {real.num_shards} real cards: the rings, the "
              "dry run and the LET tiers' peak memory a card")
        out["real"] = ring_checks(ring, cb, real, gen, dev, default, smi)
        out["real"]["dryrun"] = dryrun.dryrun_multichip(
            real, log=lambda m: print("    " + m))
        out["real"]["peak_gib"] = let_memory(real, gen, dev, default)
    else:
        print(f"    {count} CUDA device: no mesh of real cards to run; the "
              f"virtual mesh above is what [17] asserts")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"    [17] took {out['seconds']:.1f} s")
    return out


def let_checks(cb, mesh, gen, dev, default, smi) -> dict:
    """[17] The LET tiers on ``mesh``: no kernel on their path (their near
    field is plain torch, as the JAX package's is jnp), finite (an overflow
    would poison with NaN), held to the single-device tier (Barnes-Hut with
    the same far field, the FMM) and to the f64 oracle, and timed beside
    the single-device and the replicated-sharded tier, with the host reads
    of the exchange (and of the BVH walk) counted."""
    from nbody_tpu_torch.config import FMM_ORDER
    from nbody_tpu_torch.ops import bvh, fmm as fm, grid_tree as gt
    from nbody_tpu_torch.parallel import let_tree as lt
    from nbody_tpu_torch.parallel import sharded_tree as st
    from nbody_tpu_torch.parallel.let_bvh import let_bvh
    from nbody_tpu_torch.state import random_system
    out = {}

    def run(label, fn):
        reset_launches()
        r0, w0 = lt.HOST_READS["count"], bvh.HOST_READS["count"]
        got = fn()
        torch.cuda.synchronize()
        expect_launches(label, counts(), {k: 0 for k in counts()})
        reads = {"exchange": lt.HOST_READS["count"] - r0,
                 "bvh_walk": bvh.HOST_READS["count"] - w0}
        print(f"    {label}: host reads {reads}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: not finite (an overflow "
                                 "poisons every row)")
        return got, reads

    def timed(name, let, single, sharded, reads, reps=3):
        row = {"let_ms": time_ms(let, reps=reps),
               "single_ms": time_ms(single, reps=reps),
               "sharded_ms": time_ms(sharded, reps=reps),
               "host_reads": reads}
        out[name] = row
        print(f"    {name}: LET {row['let_ms']:.3f} ms, single-device "
              f"{row['single_ms']:.3f} ms, replicated-sharded "
              f"{row['sharded_ms']:.3f} ms, {smi}")

    # Barnes-Hut, theta = 0.25 (k = 3), the LET default far field ("local"):
    # held to barnes_hut_grid with the same far field.
    n, dim, theta = LET_BH
    b = random_system(n, dim, generator=gen, device=dev)
    pos, mass = b.positions, b.masses
    one = dict(theta=theta, far_impl="local", layout="dense")
    s64 = gt.barnes_hut_grid(pos, mass, default, **one).double()
    got, reads = run(f"let_barnes_hut N={n} {dim}D theta={theta}",
                     lambda: lt.let_barnes_hut(pos, mass, default, mesh=mesh,
                                               theta=theta))
    check_close(f"let_barnes_hut N={n} {dim}D vs barnes_hut_grid("
                "far_impl='local') (both fp32)", got, s64,
                tol=max(1e-5, 2 * fp32_floor(s64, K6_ULPS)))
    rows = torch.randperm(n, generator=gen)[:BH_ROWS].to(dev)
    check_close(f"let_barnes_hut N={n} {dim}D, {BH_ROWS} rows vs f64 oracle",
                got[rows], oracle64(cb, pos, mass, default, rows), tol=1e-3)
    timed(f"let_barnes_hut_{n}_{dim}d_theta{theta}",
          lambda: lt.let_barnes_hut(pos, mass, default, mesh=mesh,
                                    theta=theta),
          lambda: gt.barnes_hut_grid(pos, mass, default, **one),
          lambda: st.barnes_hut_sharded(pos, mass, default, mesh=mesh,
                                        theta=theta), reads, reps=1)
    del b, pos, mass, s64, got

    # FMM, order 8: fp32 per body against fmm_forces; f64 against the f64
    # oracle and the f64 fmm_forces.
    n, dim = LET_FMM
    order = FMM_ORDER
    b = random_system(n, dim, generator=gen, device=dev)
    pos, mass = b.positions, b.masses
    single = fm.fmm_forces(pos, mass, default, order=order)
    got, reads = run(f"let_fmm N={n} {dim}D order={order}",
                     lambda: lt.let_fmm(pos, mass, default, mesh=mesh,
                                        order=order))
    fmm_fp32_check(f"let_fmm N={n} {dim}D", got, single, pos, mass, default,
                   order)
    rows = torch.randperm(n, generator=gen)[:BH_ROWS].to(dev)
    got64, _ = run(f"let_fmm N={n} {dim}D f64",
                   lambda: lt.let_fmm(pos.double(), mass.double(), default,
                                      mesh=mesh, order=order))
    check_close(f"let_fmm N={n} {dim}D f64, {BH_ROWS} rows vs f64 oracle",
                got64[rows], oracle64(cb, pos, mass, default, rows),
                tol=FMM_GATE)
    check_close(f"let_fmm N={n} {dim}D f64 vs fmm_forces f64", got64,
                fm.fmm_forces(pos.double(), mass.double(), default,
                              order=order), tol=FMM_SHARDED_F64_TOL)
    timed(f"let_fmm_{n}_{dim}d_order{order}",
          lambda: lt.let_fmm(pos, mass, default, mesh=mesh, order=order),
          lambda: fm.fmm_forces(pos, mass, default, order=order),
          lambda: st.fmm_sharded(pos, mass, default, mesh=mesh, order=order),
          reads)
    del b, pos, mass, single, got, got64

    # BVH, theta = 0.25 quad: per-shard trees, so held to the oracle only.
    n, dim, theta = LET_BVH
    b = random_system(n, dim, generator=gen, device=dev)
    pos, mass = b.positions, b.masses
    got, reads = run(f"let_bvh N={n} {dim}D theta={theta}",
                     lambda: let_bvh(pos, mass, default, mesh=mesh,
                                     theta=theta))
    rows = torch.randperm(n, generator=gen)[:BH_ROWS].to(dev)
    check_close(f"let_bvh N={n} {dim}D, {BH_ROWS} rows vs f64 oracle",
                got[rows], oracle64(cb, pos, mass, default, rows),
                tol=BVH_TOL)
    timed(f"let_bvh_{n}_{dim}d_theta{theta}",
          lambda: let_bvh(pos, mass, default, mesh=mesh, theta=theta),
          lambda: bvh.bvh_forces(pos, mass, default, theta=theta),
          lambda: st.bvh_sharded(pos, mass, default, mesh=mesh, theta=theta),
          reads, reps=1)
    return out


def let_memory(real, gen, dev, default) -> dict:
    """Each card's peak allocated GiB during one LET run and one
    replicated-sharded run of each [17] shape, on a mesh of real cards
    (the bodies start on ``dev``)."""
    from nbody_tpu_torch.config import FMM_ORDER
    from nbody_tpu_torch.parallel import let_tree as lt
    from nbody_tpu_torch.parallel import sharded_tree as st
    from nbody_tpu_torch.parallel.let_bvh import let_bvh
    from nbody_tpu_torch.state import random_system
    runs = {
        "barnes_hut": (LET_BH[:2], lambda p, m: lt.let_barnes_hut(
            p, m, default, mesh=real, theta=LET_BH[2]),
            lambda p, m: st.barnes_hut_sharded(p, m, default, mesh=real,
                                               theta=LET_BH[2])),
        "fmm": (LET_FMM, lambda p, m: lt.let_fmm(p, m, default, mesh=real,
                                                 order=FMM_ORDER),
                lambda p, m: st.fmm_sharded(p, m, default, mesh=real,
                                            order=FMM_ORDER)),
        "bvh": (LET_BVH[:2], lambda p, m: let_bvh(p, m, default, mesh=real,
                                                  theta=LET_BVH[2]),
                lambda p, m: st.bvh_sharded(p, m, default, mesh=real,
                                            theta=LET_BVH[2])),
    }
    out = {}
    for name, ((n, dim), let, sharded) in runs.items():
        b = random_system(n, dim, generator=gen, device=dev)
        row = {}
        for kind, fn in (("let", let), ("sharded", sharded)):
            for d in real.distinct_devices:
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
            fn(b.positions, b.masses)
            row[kind] = [torch.cuda.max_memory_allocated(d) / 2 ** 30
                         for d in real.distinct_devices]
        out[name] = row
        print(f"    {name} N={n} {dim}D peak GiB a card: LET "
              f"{[round(x, 3) for x in row['let']]}, replicated-sharded "
              f"{[round(x, 3) for x in row['sharded']]}")
        del b
    return out


def trace_summary(path) -> dict:
    """From a Chrome trace of ``torch.profiler``: the CUDA kernels
    launched, their summed device time and the traced span (first event
    start to last event end), in ms."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    return {"kernels": len(kernels),
            "kernel_ms": sum(e["dur"] for e in kernels) / 1e3,
            "span_ms": (t1 - t0) / 1e3}


def phase_harness(cb, dev, default, smi) -> dict:
    """[18] The harness modules on the card: the quick sweep (no method-run
    may fail), its analysis, the FMM's phase breakdown, one traced
    Barnes-Hut evaluation (kernel launches and the device's busy share),
    the native oracle against the f64 brute force, every scenario."""
    import csv
    import glob
    import os
    from nbody_tpu_torch import models
    from nbody_tpu_torch.bench import analysis, sweep
    from nbody_tpu_torch.bench.registry import methods_for_tiers
    from nbody_tpu_torch.integrators import simulate
    from nbody_tpu_torch.ops import grid_tree as gt
    from nbody_tpu_torch.ops.brute_force import (brute_force_blocked,
                                                 brute_force_direct)
    from nbody_tpu_torch.state import random_system
    from nbody_tpu_torch.utils import native, profiling
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(HARNESS_SEED)
    out = {"card": smi}
    print(f"[18] harness modules on the card, {smi}")

    # The quick sweep: 2 sizes x 2 dims x accuracy off / on, every tier.
    expected = 8 * len(methods_for_tiers("abhf", dev))
    with tempfile.TemporaryDirectory() as tmp:
        log, err = io.StringIO(), io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log), contextlib.redirect_stderr(err):
            rc = sweep.main(["--quick", "--device", "cuda", "--results-dir",
                             tmp])
        out["sweep_s"] = time.perf_counter() - t0
        out["sweep_launches"] = {k: v for k, v in counts().items() if v}
        rows = []
        for path in sorted(glob.glob(os.path.join(tmp, "run_*.csv"))):
            with open(path) as f:
                rows.extend(csv.DictReader(f))
        failed = [r["Method"] for r in rows if float(r["Time(s)"]) < 0]
        print("    " + log.getvalue().strip().splitlines()[-1]
              + f" ({out['sweep_s']:.1f} s; launches "
              f"{out['sweep_launches']})")
        if rc or failed or len(rows) != expected or "failed:" in \
                err.getvalue():
            print(err.getvalue())
            raise AssertionError(f"quick sweep: rc {rc}, {len(rows)} rows "
                                 f"of {expected}, failed {failed}")
        out["sweep_method_runs"] = len(rows)
        alog = io.StringIO()
        with contextlib.redirect_stdout(alog):
            rc = analysis.main([tmp])
        agg = analysis.aggregate(analysis.load_results(tmp))
        runs = sum(v["Runs"] for v in agg.values())
        print("    analysis: " + alog.getvalue().strip().splitlines()[0])
        if rc or runs != len(rows):
            raise AssertionError(f"analysis: rc {rc}, {runs} of {len(rows)}")
        out["speedups"] = {f"{r['Method']}_{r['Bodies']}_{r['Dimension']}d":
                           r["Speedup"] for r in analysis.speedup_table(agg)}

    # The FMM's phase breakdown (a warm-up run first).
    n, dim = HARNESS_FMM
    b = random_system(n, dim, generator=gen, device=dev)
    profiling.phase_breakdown_fmm(b.positions, b.masses, default, order=8)
    timer = profiling.phase_breakdown_fmm(b.positions, b.masses, default,
                                          order=8)
    print(f"    phase_breakdown_fmm N={n} {dim}D order 8:")
    for line in timer.report().splitlines():
        print("      " + line)
    out["fmm_phases_ms"] = {k: v * 1e3 for k, v in timer.times.items()}

    # One traced Barnes-Hut evaluation: launches and busy share.
    n, dim, theta = TRACE_BH
    b = random_system(n, dim, generator=gen, device=dev)
    gt.barnes_hut_grid(b.positions, b.masses, default, theta=theta)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tdir:
        with profiling.trace(tdir):
            gt.barnes_hut_grid(b.positions, b.masses, default, theta=theta)
            torch.cuda.synchronize()
        tr = trace_summary(os.path.join(tdir, "trace.json"))
    if tr["kernels"] == 0:
        raise AssertionError("the trace recorded no CUDA kernel")
    tr["busy_share"] = tr["kernel_ms"] / tr["span_ms"]
    out["trace_bh"] = tr
    print(f"    traced barnes_hut_grid N={n} {dim}D theta={theta}: "
          f"{tr['kernels']} kernel launches, {tr['kernel_ms']:.3f} ms of "
          f"kernels in a {tr['span_ms']:.3f} ms span: device busy "
          f"{100 * tr['busy_share']:.1f}%, {smi}")

    # The native oracle (built here) against the f64 brute force.
    # The Makefile's flags first; where the compiler has no OpenMP runtime
    # (no libgomp), the same flags without -fopenmp: the oracle's loops
    # then run serially, with the same results.
    make = ["make", "-C", "native"]
    made = subprocess.run(make, capture_output=True, text=True)
    out["native_build"] = "openmp"
    if made.returncode and "gomp" in made.stdout + made.stderr:
        out["native_build"] = "serial (no OpenMP runtime)"
        made = subprocess.run(make + ["CXXFLAGS=-std=c++17 -O3 -fPIC -Wall "
                                      "-Wextra"], capture_output=True,
                              text=True)
    if made.returncode:
        raise AssertionError(f"make -C native: rc {made.returncode}\n"
                             f"{made.stdout}{made.stderr}")
    print(f"    make -C native: built, {out['native_build']}")
    if not native.available():
        raise AssertionError("native oracle not loadable after make")
    b = random_system(NATIVE_N, 2, generator=gen, device=dev,
                      dtype=torch.float64)
    want = brute_force_blocked(b.positions, b.masses, default)
    t0 = time.perf_counter()
    got = native.brute_force_native(b.positions.cpu().numpy(),
                                    b.masses.cpu().numpy(), default.G,
                                    default.softening)
    out["native_s"] = time.perf_counter() - t0
    check_close(f"native oracle N={NATIVE_N} 2D vs the port's f64 brute "
                f"force on the card ({out['native_s']:.2f} s host)",
                torch.from_numpy(got).to(dev), want, tol=NATIVE_TOL)

    # Every scenario on the card; the binary closes after one period.
    g = torch.Generator().manual_seed(HARNESS_SEED + 1)
    built = {
        "uniform_random": models.uniform_random(4096, generator=g,
                                                device=dev),
        "plummer_sphere": models.plummer_sphere(4096, generator=g,
                                                device=dev),
        "spiral_galaxy": models.spiral_galaxy(4096, generator=g, device=dev),
        "two_body_circular_orbit": models.two_body_circular_orbit(dev),
        "solar_system": models.solar_system(dev),
    }
    for name, (sys_, cfg) in built.items():
        ok = all(t.device == dev and bool(torch.isfinite(t).all())
                 for t in (sys_.positions, sys_.velocities, sys_.masses))
        print(f"    {name}: N={sys_.n} {sys_.dim}D {sys_.dtype} on "
              f"{sys_.positions.device}, G={cfg.G:g}, finite {ok}")
        if not ok:
            raise AssertionError(f"scenario {name}")
    s0, cfg = built["two_body_circular_orbit"]
    steps = 2000
    final, _ = simulate(s0, lambda p, m: brute_force_direct(p, m, cfg),
                        dt=4.0 * math.pi / steps, num_steps=steps)
    drift = float((final.positions - s0.positions).abs().max())
    sep = float(torch.linalg.norm(final.positions[0] - final.positions[1]))
    print(f"    two-body orbit, one period, {steps} leapfrog steps f64 on "
          f"the card: max drift {drift:.3e} (tol 5e-3), separation "
          f"{sep:.6f} (2 within 1e-3)")
    if not (drift < 5e-3 and abs(sep - 2.0) < 2e-3):
        raise AssertionError(f"two-body orbit: drift {drift}, sep {sep}")
    out["orbit_drift"] = drift
    out["seconds"] = time.perf_counter() - t_phase
    print(f"    [18] took {out['seconds']:.1f} s")
    return out


def graph_matches_eager(dsb, name, system, unit) -> float:
    """The state after STEP_CHECK_K Euler steps replayed from one CUDA graph
    against as many eager steps: the largest difference over the largest
    value, positions and velocities; raises past the method's bound."""
    fn = dsb.step_force_fn(name, system.positions, system.masses, unit)
    want = dsb.euler_steps(fn, system, STEP_CHECK_K, STEP_DT)
    got = dsb.GraphSteps(fn, system, STEP_DT).run(STEP_CHECK_K)
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in ((got.positions, want.positions),
                           (got.velocities, want.velocities)))
    moved = float((want.positions - system.positions).abs().max())
    exact = name == "BruteForce_Torch"
    ok = moved > 0 and (torch.equal(got.positions, want.positions)
                        and torch.equal(got.velocities, want.velocities)
                        if exact else rel <= STEP_K1_REL)
    print(f"    {name} N={system.n} {system.dim}D: {STEP_CHECK_K} steps "
          f"replayed from one graph vs eager: rel diff {rel:.3e} "
          f"({'bit for bit' if exact else f'tol {STEP_K1_REL:g}'}), "
          f"bodies moved {moved:.3e}")
    if not ok:
        raise AssertionError(f"graph vs eager {name} N={system.n}: rel "
                             f"{rel}, moved {moved}")
    return rel


def phase_entry(dev, smi) -> dict:
    """[19] The entry points outside the library on the card: the
    device-step bench (graph and eager rows; graph replays held to eager
    steps), simulate_1m on a Plummer sphere, the method smoke at 2D and 3D,
    the multichip tool with its collective census. K1 (the graph rows), K2
    and K3 (the rings) and K6 (the tree adapters) must launch."""
    import csv
    import os
    from nbody_tpu_torch import GravityConfig
    from nbody_tpu_torch.state import plummer_system
    from nbody_tpu_torch.tools import (device_step_bench as dsb,
                                       method_smoke, multichip_scaling,
                                       simulate_1m)
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(ENTRY_SEED)
    unit = GravityConfig(G=1.0, softening=0.05)
    out = {"card": smi}
    print(f"[19] entry points on the card, {smi}")
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "device_step_times.csv")
        t0 = time.perf_counter()
        # Min of 3 runs a K at the small N, one run at the large (whose
        # steps take milliseconds to a second: the host's jitter is far
        # below them).
        rc = 0
        for n_rows, reps in zip(STEP_N, STEP_REPEATS):
            rc = rc or dsb.main(["-N", str(n_rows), "--dim", "2", "3",
                                 "--methods", ",".join(dsb.GRAPH_METHODS),
                                 "--repeats", str(reps), "--out", csv_path])
        n, dim = STEP_TREE
        trees = [m for m in dsb.ADAPTERS if m not in dsb.GRAPH_METHODS]
        rc = rc or dsb.main(["-N", str(n), "--dim", str(dim), "--methods",
                             ",".join(trees), "--repeats", "1", "--out",
                             csv_path])
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        out["device_step_s"] = time.perf_counter() - t0
        want = len(STEP_N) * 2 * len(dsb.GRAPH_METHODS) + len(trees)
        dispatch = {(r["Method"], r["Dispatch"]) for r in rows}
        if rc or len(rows) != want or dispatch != {
                (m, "graph") for m in dsb.GRAPH_METHODS} | {
                (m, "eager") for m in trees}:
            raise AssertionError(f"device_step_bench: rc {rc}, rows {rows}")
        out["device_step_rows"] = [
            {"n": int(r["Bodies"]), "method": r["Method"],
             "dim": int(r["Dimension"]), "step_ms": 1e3 * float(
                 r["StepTime(s)"]), "steps": int(r["Steps"]),
             "dispatch": r["Dispatch"]} for r in rows]
        for r in out["device_step_rows"]:
            print(f"    row N={r['n']} {r['dim']}D {r['method']}: "
                  f"{r['step_ms']:.6f} ms/step, {r['dispatch']}, "
                  f"differenced over {r['steps']} steps")

        out["graph_vs_eager_rel"] = {}
        for d in (2, 3):
            for n in STEP_N:
                bodies = plummer_system(n, d, generator=gen, device=dev)
                for name in dsb.GRAPH_METHODS:
                    out["graph_vs_eager_rel"][f"{name}_{n}_{d}d"] = \
                        graph_matches_eager(dsb, name, bodies, unit)

        json_path = os.path.join(tmp, "simulate_1m.json")
        t0 = time.perf_counter()
        rc = simulate_1m.main(["--n", str(SIM1M_N), "--steps",
                               str(SIM1M_STEPS), "--out", json_path])
        out["simulate_s"] = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"simulate_1m: rc {rc}")
        with open(json_path) as f:
            sim = json.load(f)
        out["simulate"] = {k: sim[k] for k in (
            "n", "steps", "relative_energy_drift", "seed_eval_s",
            "step_wall_s", "energy_s")}
        if not math.isfinite(sim["relative_energy_drift"]):
            raise AssertionError(f"simulate_1m drift {sim}")

        out["method_smoke"] = {}
        t0 = time.perf_counter()
        for d in (2, 3):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                rc = method_smoke.main(["-N", str(SMOKE_N), "--dim", str(d)])
            print("    " + log.getvalue().strip().replace("\n", "\n    "))
            if rc:
                raise AssertionError(f"method_smoke {d}D: rc {rc}")
            out["method_smoke"][f"{d}d"] = {
                m.group(1): float(m.group(2)) for m in re.finditer(
                    r"^\s+(\S+)\s+err=(\S+)", log.getvalue(), re.M)}
        out["method_smoke_s"] = time.perf_counter() - t0

        mc_path = os.path.join(tmp, "multichip_scaling.json")
        t0 = time.perf_counter()
        rc = multichip_scaling.main(["--n", str(MULTI_TOOL_N),
                                     "--mesh-sizes", MULTI_TOOL_P,
                                     "--out", mc_path])
        out["multichip_s"] = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"multichip_scaling: rc {rc}")
        with open(mc_path) as f:
            mc = json.load(f)["tiers"]
        for p in map(int, MULTI_TOOL_P.split(",")):
            rot = mc["ring_one_sided"][str(p)]["collectives"]["rotate"]
            print(f"    one-sided ring P={p}: {rot['count']} rotates "
                  f"(P - 1 = {p - 1}), {rot['out_bytes']} bytes")
            if rot["count"] != p - 1:
                raise AssertionError(f"one-sided ring census P={p}: {rot}")
        out["census_p4"] = {t: mc[t]["4"]["collectives"] for t in mc
                            if "collectives" in mc[t].get("4", {})}
        out["multichip_err"] = {f"{t}_p{p}": row.get("err_vs_direct")
                                for t, by_p in mc.items()
                                for p, row in by_p.items()}
    out["launches"] = {k: v for k, v in counts().items() if v}
    print(f"    [19] launches: {out['launches']}")
    for k in ("symmetric", "precise", "sym_tile", "near_field"):
        if not counts()[k]:
            raise AssertionError(f"[19]: kernel {k} never launched")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"    [19] took {out['seconds']:.1f} s (device-step "
          f"{out['device_step_s']:.1f}, simulate_1m {out['simulate_s']:.1f}, "
          f"method smoke {out['method_smoke_s']:.1f}, multichip "
          f"{out['multichip_s']:.1f})")
    return out


def failed_rows(record, where="") -> list:
    """Every ``error`` entry of a probe's record, with where it stands."""
    if isinstance(record, dict):
        found = [f"{where}: {record['error']}"] if "error" in record else []
        for key, value in record.items():
            found += failed_rows(value, f"{where}.{key}")
        return found
    if isinstance(record, list):
        return [e for i, v in enumerate(record)
                for e in failed_rows(v, f"{where}[{i}]")]
    return []


def check_probe(name, rec) -> None:
    """Raise unless a probe's record passes its gate (PROBES' comment)."""
    def need(ok, what):
        if not ok:
            raise AssertionError(f"[20] {name}: {what}")
    if name == "clustered_stress":
        need(rec["dense_grid_guard_refused"], "the dense layout ran")
        for key in ("bvh_sampled_norm_error_vs_f64",
                    "sparse_grid_sampled_norm_error_vs_f64"):
            need(rec[key] < PROBE_TOL, f"{key} {rec[key]}")
    elif name == "local_leaf_check":
        errs = {r["far_impl"]: r["err"] for r in rec["rows"]}
        need(all(math.isfinite(r["err"]) and math.isfinite(r["acc"])
                 for r in rec["rows"]), f"rows {rec['rows']}")
        need(errs["point"] < PROBE_TOL and errs["hier"] < PROBE_TOL,
             f"errors {errs}")
    elif name == "bh_near_probe":
        first = {}
        for r in rec["rows"]:
            key = (r["level"], r["batch"])
            if key not in first:
                first[key] = r
            elif r["impl"] == "cuda":
                tol = max(1e-5, 2 * K6_ULPS * 2.0 ** -24
                          * first[key]["max_over_rms"])
                need(r["err_vs_first"] <= tol,
                     f"K6 row {r} beyond {tol:.3e} of the plain row")
        need(any(r["impl"] == "cuda" for r in rec["rows"]), "no K6 row")
    elif name == "brute_variants":
        for r in rec["rows"]:
            tol = (PROBE_CHECKSUM_REL_MXU if r["label"].startswith("mxu")
                   else PROBE_CHECKSUM_REL)
            need(r["checksum_rel_diff"] < tol,
                 f"checksum of {r['label']}: {r['checksum_rel_diff']}")
    elif name == "mxu_narrow_bench":
        for r in rec["rows"]:
            if "err_vs_f64" in r:
                need(r["err_vs_f64"] < MATMUL_TOL, f"P's product {r}")
    elif name == "smalln_floor":
        for key in rec["jax_keys"]:
            need(rec[key]["per_step_s"] > 0, f"{key} {rec[key]}")
        rel = rec["brute_force_cuda_symmetric"]["graph_vs_eager_rel"]
        need(rel <= STEP_K1_REL, f"K1 graph vs eager {rel}")


def phase_probes(smi) -> dict:
    """[20] The repo's probes on the card, each through its main(argv)
    (PROBES), its record held to its gate and its launches counted."""
    import importlib
    import os
    t_phase = time.perf_counter()
    print(f"[20] the repo's probes on the card, {smi}")
    out = {"card": smi, "probes": [], "launches": {k: 0 for k in counts()}}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, argv, kernels) in enumerate(PROBES):
            mod = importlib.import_module(f"nbody_tpu_torch.tools.{name}")
            path = os.path.join(tmp, f"{i}_{name}.json")
            print(f"    [20] {name} {' '.join(argv)}")
            reset_launches()
            t0 = time.perf_counter()
            rc = mod.main(argv + ["--out", path])
            seconds = time.perf_counter() - t0
            launched = {k: v for k, v in counts().items() if v}
            if rc:
                raise AssertionError(f"[20] {name}: rc {rc}")
            with open(path) as f:
                rec = json.load(f)
            bad = failed_rows(rec)
            if bad:
                raise AssertionError(f"[20] {name}: failed rows {bad}")
            check_probe(name, rec)
            missing = [k for k in kernels if not launched.get(k)]
            stray = sorted(set(launched) - set(kernels))
            print(f"    [20] {name}: {seconds:.1f} s, launches {launched}")
            if missing or stray:
                raise AssertionError(f"[20] {name}: launches {launched}, "
                                     f"expected {kernels}")
            for k, v in launched.items():
                out["launches"][k] += v
            out["probes"].append({"name": name, "argv": argv,
                                  "seconds": seconds, "launches": launched})
    out["seconds"] = time.perf_counter() - t_phase
    print(f"    [20] launches: {out['launches']}")
    print(f"    [20] took {out['seconds']:.1f} s")
    return out


def kernels_line(t, launches, k1_err, k2_err, k3, k4, k5, k6, bh, fmm, pr,
                 ptxas, multi, entry, probes, sparse) -> list:
    """The kernels JSON line: every kernel with its launches on its path,
    its error against its plain version, its times and its bound; K2, K3
    and K6 also with their launches on [17]'s multi-device paths (the
    paths' own times are in :func:`multi_line`); K1, K2, K3 and K6 with
    their launches on [19]'s entry points (the graph rows' K1 counted at
    capture, once a captured launch)."""
    entry_launches = entry["launches"]
    probe_launches = probes["launches"]
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
    ring_launches = multi["ring"]["launches"]
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
         "entry_launches": entry_launches.get("symmetric", 0),
         "probe_launches": probe_launches["symmetric"],
         **bounds["K1"], "library_ms": None},
        {"name": "K2 precise (one-sided tile)", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/precise.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:78",
         "launches": launches["precise"], "max_abs_err": k2_err,
         "ms": t["K2"], "plain_ms": t["K2_plain"], "timed_at": timed_at,
         "ms_n1048576_2d": big["precise"],
         "ring_launches": ring_launches["precise"],
         "ring_shards": MULTI_SHARDS,
         "entry_launches": entry_launches.get("precise", 0),
         "probe_launches": probe_launches["precise"],
         **bounds["K2"], "library_ms": None},
        {"name": "K3 sym tile (Newton-3 rectangle, the ring's tiles)",
         "route": "cuda", "source": "nbody_tpu_torch/csrc/sym_tile.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:497",
         "launches": k3["launches"], "max_abs_err": k3["max_abs_err"],
         "ms": t["K3"], "plain_ms": t["K3_plain"],
         "timed_at": f"{TIMED_N} x {TIMED_N} 2D fp32 cross tile",
         "ring_launches": ring_launches["sym_tile"],
         "ms_n262144_3d": t["K3_3d"],
         "bound_ms_n262144_3d": bounds["K3_3d"]["bound_ms"],
         "ptxas": {k: v for k, v in n3_ptxas.items()
                   if k.startswith("newton3") and k.endswith(",0>")},
         "entry_launches": entry_launches.get("sym_tile", 0),
         "probe_launches": probe_launches["sym_tile"],
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
         "probe_launches": probe_launches["fused_steps"],
         "ptxas": {k: v for k, v in ptxas.items()
                   if k.startswith("fused_steps")},
         **bounds["K4"], "library_ms": None},
        {"name": "K5 mxu (block-centred matmul-form tile)", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/mxu.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:264",
         "launches": k5["launches"], "max_abs_err": k5["max_abs_err"],
         "ms": t["K5"], "plain_ms": t["K5_plain"], "timed_at": timed_at,
         "k2_ms": t["K2"], "probe_launches": probe_launches["mxu"],
         **bounds["K5"], "library_ms": None},
        {"name": "K6 near field (tree kernel; window entry p2p_leaf)",
         "route": "cuda", "source": "nbody_tpu_torch/csrc/p2p_leaf.cu",
         "replaces": "nbody_tpu/ops/pallas_p2p.py:30",
         "launches": bh["launches"] + fmm["launches"],
         "launches_by_path": {"barnes_hut": bh["launches"],
                              "fmm": fmm["launches"]},
         "sharded_launches": {"barnes_hut": multi["bh_launches"],
                              "fmm": multi["fmm_launches"]},
         "entry_launches": entry_launches.get("near_field", 0),
         "probe_launches": probe_launches["near_field"],
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
        k6_occupied_row(sparse, entry_launches, probe_launches),
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
         "probe_launches": probe_launches["rate_probe"],
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
         "probe_launches": probe_launches["matmul_probe"],
         **p_bounds[128], "library_ms": mm[128]["library_ms"]},
    ]
    return kernels


def k6_occupied_row(sparse, entry_launches, probe_launches) -> dict:
    """The kernels line's row of K6's occupied-leaf entry, from [15]: its
    launches on the FMM's path, its error against its plain version, its
    time and bound on the Plummer tree at leaf level 10, the same on the
    collapsed core."""
    occ = sparse["k6_occupied"]["plummer_L10"]
    return {
        "name": "K6 occupied-leaf entry (the FMM's occupied-cell layout)",
        "route": "cuda", "source": "nbody_tpu_torch/csrc/p2p_leaf.cu",
        "replaces": "nbody_tpu/ops/pallas_p2p.py:30",
        "launches": sparse["occupied_launches"],
        "max_abs_err": occ["max_abs_err"], "ms": occ["ms"],
        "plain_ms": None, "real_pairs": occ["real_pairs"],
        "timed_at": "one launch, wrapper included, on [15]'s Plummer 1e5 3D "
                    "tree at leaf level 10, fp32",
        "ops_per_pair": 21,
        "collapsed_L10": sparse["k6_occupied"]["collapsed_L10"],
        "entry_launches": entry_launches.get("near_field_occupied", 0),
        "probe_launches": probe_launches.get("near_field_occupied", 0),
        **{k: occ[k] for k in ("bound_ms", "bound_by", "mufu_bound_ms")},
        "library_ms": None}


def multi_line(multi, smi) -> dict:
    """[17]'s paths as whole runs on MULTI_SHARDS virtual shards, each
    beside its single-device comparator from the same run: the rings
    (K2 and K3 launches together) and the sharded tiers."""
    ring = multi["ring"]
    return {"shards": MULTI_SHARDS, "card": smi,
            "ring_ms_n1048576_2d": ring["ring_ms"],
            "k1_ms_n1048576_2d": ring["k1_ms"],
            "one_sided_ring_ms_n262144_3d": ring["one_sided_ms_3d"],
            "tiers": multi["times"], "let": multi["let"],
            "peak_gib_real_cards": multi.get("real", {}).get("peak_gib")}


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
    from nbody_tpu_torch.tools.common import card_line
    from nbody_tpu_torch.utils import cuda_build

    # K5's plain version is a matmul: it must run in full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    t_run = time.perf_counter()

    # 1. Device.
    dev = torch.device("cuda", 0)
    smi = card_line(dev)
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

    # 5-6. The main path, counted. Simulation("brute") takes K1 from
    # cb.K1_MIN_N bodies up and K2 below (brute_force_routed): SIM_N runs on
    # K1 and SIM_SMALL_N on K2, so both kernels stay gated on the path.
    if not SIM_SMALL_N < cb.K1_MIN_N <= SIM_N:
        raise AssertionError(f"K1_MIN_N {cb.K1_MIN_N} must lie in "
                             f"({SIM_SMALL_N}, {SIM_N}]")
    reset_launches()
    small = plummer_system(SIM_SMALL_N, 3, generator=gen, device=dev)
    for bodies, kernel, other in ((small, "precise", "symmetric"),
                                  (plum, "symmetric", "precise")):
        n = bodies.positions.shape[0]
        name = {"precise": "K2", "symmetric": "K1"}[kernel]
        print(f"[5] Simulation(method='brute').run(steps=3, dt=1e-3), "
              f"N={n} 3D Plummer, G=1, softening=0.1: {name}")
        before = dict(counts())
        t0 = time.perf_counter()
        sim = Simulation.create(bodies, unit, method="brute").run(steps=3,
                                                                  dt=1e-3)
        torch.cuda.synchronize()
        print(f"    ran in {time.perf_counter() - t0:.2f} s")
        # A fresh handle's first leapfrog step evaluates F(x0) and F(x1);
        # each later step's F(x0) is the carried F(x1) of the step before.
        expect_launches(f"N={n} 3 steps",
                        {k: counts()[k] - before[k] for k in (kernel, other)},
                        {kernel: 1 + 3, other: 0})
        before = dict(counts())
        fourth = sim.run(steps=1, dt=1e-3)
        torch.cuda.synchronize()
        expect_launches(f"N={n} a fourth step from the returned handle",
                        {k: counts()[k] - before[k] for k in (kernel, other)},
                        {kernel: 1, other: 0})
        if fourth.step_count != 4:
            raise AssertionError(f"step count {fourth.step_count} != 4")
        plain_fn = lambda p, m: brute_force_blocked(p, m, unit)  # noqa: E731
        ref = bodies
        for _ in range(3):
            ref = leapfrog_step(ref, plain_fn, 1e-3)
        # Both runs are fp32 and differ only in summation order:
        # accelerations agree within FORCE_TOL (scale-normalized), and from a
        # cold start the velocities are sums of them, so they are held to
        # the same bound. Positions move by ~1e-6 of their size in 3 steps
        # and must agree to 1e-5 of the largest coordinate.
        check_states(f"N={n} 3 steps vs plain blocked path on the card",
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
    sparse = phase_sparse(cb, seeded(15), dev, default, smi)
    phase_bvh(cb, dev, default, smi, sparse)
    multi = phase_multi(cb, dev, default, smi)
    harness = phase_harness(cb, dev, default, smi)
    entry = phase_entry(dev, smi)
    probes = phase_probes(smi)

    kernels = kernels_line(t, launches, k1_err, k2_err, k3, k4, k5, k6, bh,
                           fmm, pr, ptxas, multi, entry, probes, sparse)
    print(f"chip_smoke: phases [1]-[20] in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"multi_device": multi_line(multi, smi)}))
    print(json.dumps({"harness": harness}))
    print(json.dumps({"entry_points": entry}))
    print(json.dumps({"probes": probes}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
