#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nbody_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the two brute-force CUDA kernels from ``nbody_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the
port's main path (``Simulation(method="brute")`` and the benchmark CLI at
N = 2^20), checks that the path went through the kernels, and times them.
Every check raises on failure, so any failed phase exits non-zero. The last
line is one JSON object naming the device; the line before it lists the
kernels with their launches, errors and times.

Needs one CUDA device; exits non-zero without one. Imports no JAX.
"""

from __future__ import annotations

import contextlib
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


def time_ms(fn, reps: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after 1 warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def coincident_set(n, gen, dev):
    """softening=0 inputs with two coincident bodies (the guard must hold)."""
    pos = torch.empty((n, 3), dtype=torch.float64)
    pos[:2] = torch.tensor([1.0, 1.0, 1.0])
    pos[2] = torch.tensor([5.0, 1.0, 1.0])
    pos[3:] = 10.0 + 10.0 * torch.rand((n - 3, 3), generator=gen,
                                       dtype=torch.float64)
    return pos.to(dev, torch.float32), torch.ones(n, device=dev)


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
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("    " + line.strip())

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

    def oracle64(pos, mass, cfg, rows=None):
        """f64 one-sided plain forces (optionally on sampled rows)."""
        pos64, m64 = pos.double(), mass.double()
        tgt = pos64 if rows is None else pos64[rows]
        tm = m64 if rows is None else m64[rows]
        return (cfg.G * tm)[:, None] * cb.pairwise_accel_plain(
            tgt, pos64, m64, cfg.softening)

    # 3. K2 against its plain version.
    print("[3] K2 precise kernel vs f64 plain version")
    for label, pos, mass, cfg in sets:
        got = cb.brute_force_cuda(pos, mass, cfg, mode="precise")
        check_close(label, got, oracle64(pos, mass, cfg))
    plum = plummer_system(SIM_N, 3, generator=gen, device=dev)
    unit = GravityConfig(G=1.0, softening=0.1)
    rows = torch.randperm(SIM_N, generator=gen)[:4096].to(dev)
    got = cb.brute_force_cuda(plum.positions, plum.masses, unit,
                              mode="precise")
    k2_err = check_close(f"main-path shape N={SIM_N} 3D Plummer, 4096 rows",
                         got[rows], oracle64(plum.positions, plum.masses,
                                             unit, rows))

    # 4. K1 against its plain version.
    print("[4] K1 symmetric kernel vs f64 plain version (block pairs)")
    extra = [random_system(5000, 3, generator=gen, device=dev),
             random_system(3000, 2, generator=gen, device=dev)]
    k1_sets = sets + [("N=5000 3D", extra[0].positions, extra[0].masses,
                       default),
                      ("N=3000 2D", extra[1].positions, extra[1].masses,
                       default)]
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
                         got[rows], oracle64(head.positions, head.masses,
                                             default, rows))
    del got, head

    # 5-6. The main path, counted.
    for k in cb.LAUNCHES:
        cb.LAUNCHES[k] = 0
    print(f"[5] Simulation(method='brute').run(steps=3, dt=1e-3), "
          f"N={SIM_N} 3D Plummer, G=1, softening=0.1")
    t0 = time.perf_counter()
    sim = Simulation.create(plum, unit, method="brute").run(steps=3, dt=1e-3)
    torch.cuda.synchronize()
    print(f"    ran in {time.perf_counter() - t0:.2f} s; K2 launches "
          f"{cb.LAUNCHES['precise']}")
    if cb.LAUNCHES["precise"] != 2 * 3:
        raise AssertionError(f"K2 launches {cb.LAUNCHES['precise']} != 6")
    plain_fn = lambda p, m: brute_force_blocked(p, m, unit)  # noqa: E731
    ref = plum
    for _ in range(3):
        ref = leapfrog_step(ref, plain_fn, 1e-3)
    # Both runs are fp32 and differ only in summation order: accelerations
    # agree within FORCE_TOL (scale-normalized), and from a cold start the
    # velocities are sums of them, so they are held to the same bound.
    # Positions move by ~1e-6 of their size in 3 steps and must agree to
    # 1e-5 of the largest coordinate.
    check_close("velocities vs plain blocked path on the card",
                sim.system.velocities, ref.velocities.double())
    pos_err = float((sim.system.positions - ref.positions).abs().max()
                    / ref.positions.abs().max())
    print(f"  positions: max abs diff / max |x| = {pos_err:.3e} (tol 1e-5)")
    if not pos_err < 1e-5:
        raise AssertionError(f"positions differ: {pos_err}")
    with tempfile.TemporaryDirectory() as tmp:
        sim.save(tmp)
        back = Simulation.load(tmp, unit, device=dev)
        if back.step_count != 3 or not torch.equal(back.system.positions,
                                                   sim.system.positions):
            raise AssertionError("checkpoint round trip changed the state")
    print("  save/load round trip: identical state, step 3")

    print(f"[6] CLI: -d 2 -N {HEADLINE_N} -m a --no-files --device cuda")
    before = cb.LAUNCHES["symmetric"]
    rc = cli.main(["-d", "2", "-N", str(HEADLINE_N), "-m", "a", "--no-files",
                   "--device", "cuda"])
    if rc != 0 or cb.LAUNCHES["symmetric"] <= before:
        raise AssertionError(f"CLI rc {rc}, K1 launches "
                             f"{cb.LAUNCHES['symmetric'] - before}")
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
    launches = dict(cb.LAUNCHES)
    print(f"    main-path launches: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    # 7. Times.
    print(f"[7] times (CUDA events, 1 warm-up, median of 3), {smi}")
    head = random_system(HEADLINE_N, 2, generator=gen, device=dev)
    big = {mode: time_ms(lambda: cb.brute_force_cuda(
        head.positions, head.masses, default, mode=mode))
        for mode in ("symmetric", "precise")}
    print(f"    N={HEADLINE_N} 2D fp32: K1 symmetric {big['symmetric']:.3f} ms,"
          f" K2 precise {big['precise']:.3f} ms")
    del head
    # The plain versions take minutes at 2^20, so all three are also timed
    # at TIMED_N, where the plain ones finish in seconds.
    small = random_system(TIMED_N, 2, generator=gen, device=dev)
    p, mm = small.positions, small.masses
    t = {
        "K1": time_ms(lambda: cb.brute_force_cuda(p, mm, default,
                                                  mode="symmetric")),
        "K1_plain": time_ms(lambda: cb.symmetric_forces_plain(p, mm, default)),
        "K2": time_ms(lambda: cb.brute_force_cuda(p, mm, default,
                                                  mode="precise")),
        "K2_plain": time_ms(lambda: (default.G * mm)[:, None]
                            * cb.pairwise_accel_plain(p, p, mm,
                                                      default.softening)),
    }
    print(f"    N={TIMED_N} 2D fp32: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in t.items()))

    timed_at = f"N={TIMED_N} 2D fp32"
    kernels = [
        {"name": "K1 symmetric (Newton-3 block pairs)", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/symmetric.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:135",
         "launches": launches["symmetric"], "max_abs_err": k1_err,
         "ms": t["K1"], "plain_ms": t["K1_plain"], "timed_at": timed_at,
         "ms_n1048576_2d": big["symmetric"]},
        {"name": "K2 precise (one-sided tile)", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/precise.cu",
         "replaces": "nbody_tpu/ops/pallas_brute.py:78",
         "launches": launches["precise"], "max_abs_err": k2_err,
         "ms": t["K2"], "plain_ms": t["K2_plain"], "timed_at": timed_at,
         "ms_n1048576_2d": big["precise"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
