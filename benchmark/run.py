"""Run one cell of the benchmark once and print its result as one JSON line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the bodies are drawn on the card from the seed
(:mod:`benchmark.inputs`), ``Simulation.create`` builds the simulation of the
cell's mix on them (the ring mix puts ``ring_brute_force`` over the cell's
cards in its ``forces_fn``), and the warm-up steps run through
``Simulation.run``: the first use builds or loads the kernel library. The
window then calls ``Simulation.run(steps=1, dt)`` again and again, each step
ending in a synchronize of the cell's cards, until ``--seconds`` have passed.
A wrapper around ``forces_fn`` counts the force calls, keeps what the
checked steps computed, and in a traced run (``--trace 1``) times each call
(ending it in a synchronize). A traced run also profiles the window's first
step with ``torch.profiler``.

After the window the reference (:mod:`benchmark.reference`) judges the first
warm-up step, from the generated bodies, and the window's last step, from
the program's own state before it (:mod:`benchmark.check`). The last line of
standard output holds ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, also the last lines of standard error.

Exit 2, and no result, without as many CUDA cards as the cell asks for or
without the port beside this folder; exit 3 if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

import torch  # noqa: E402

from benchmark import catalog, check, inputs, reference, tracing  # noqa: E402

ROOT = catalog.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")
# Caches a library could keep, each at a fixed path inside the checkout.
# The port's own kernel library is built into nbody_tpu_torch/_build/.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
# The energy drift (N² pairs in float64) is printed only up to this N.
ENERGY_MAX_N = 200_000
# Steps a traced run profiles, from the window's first: one step of the
# trees is 27k-36k launches, and a Chrome trace of more would run to
# hundreds of MB.
TRACE_STEPS = 1


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class RunRecord:
    """What one run measured, handed to every metric's reader."""

    name: str
    cell: dict
    config: dict
    mix: dict
    chips: int
    n: int
    dim: int
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    force_calls: int = 0
    # Traced runs: (step seconds, [its force calls' seconds], profiled).
    step_spans: list = dataclasses.field(default_factory=list)
    snapshots: dict = dataclasses.field(default_factory=dict)
    trace: Optional[tracing.TraceSummary] = None


class ForceProbe:
    """Wraps ``forces_fn``: counts calls, keeps (positions, forces) of the
    calls while ``record`` is a list, and times each call while ``spans``
    is a list (the call then ends in ``sync``)."""

    def __init__(self, fn: Callable, sync: Callable[[], None]):
        self.fn, self.sync = fn, sync
        self.calls = 0
        self.record: Optional[list] = None
        self.spans: Optional[list] = None

    def __call__(self, positions, masses):
        self.calls += 1
        if self.spans is None:
            out = self.fn(positions, masses)
        else:
            t = time.perf_counter()
            with torch.profiler.record_function("bench::force_call"):
                out = self.fn(positions, masses)
                self.sync()
            self.spans.append(time.perf_counter() - t)
        if self.record is not None:
            self.record.append((positions, out))
        return out


def cell_devices(device_type: str, chips: int) -> List[torch.device]:
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [torch.device(device_type)] * chips


def build_simulation(config: dict, mix: dict, bodies, devices):
    """``Simulation.create`` on the bodies with the mix's method and
    parameters; the ring mix replaces ``forces_fn`` by the Newton-3 ring
    over a mesh of ``devices``. Returns (simulation, mesh or None)."""
    from nbody_tpu_torch.config import GravityConfig, TreeConfig
    from nbody_tpu_torch.simulation import Simulation
    from nbody_tpu_torch.state import System
    gravity = GravityConfig(G=config["G"], softening=config["softening"],
                            **mix.get("gravity", {}))
    tree = TreeConfig(**mix.get("tree", {}))
    pos, vel, mass = bodies
    sim = Simulation.create(System(pos, vel, mass), gravity, tree,
                            method=mix["method"], integrator=mix["integrator"])
    engine = mix.get("forces", "simulation")
    if engine == "simulation":
        return sim, None
    if engine == "ring":
        from nbody_tpu_torch.parallel.mesh import make_mesh
        from nbody_tpu_torch.parallel.ring import ring_brute_force
        mesh = make_mesh(devices)
        return dataclasses.replace(sim, forces_fn=functools.partial(
            ring_brute_force, config=gravity, mesh=mesh)), mesh
    raise ValueError(f"unknown force engine {engine!r}")


def _checked_step(before, calls, after, rows):
    """What the check needs of one step: every body's positions before and
    after (the reference sums over them), the rows of the rest."""
    return {"x0": before.positions, "v0": before.velocities,
            "x1_all": after.positions, "x1": after.positions[rows],
            "v1": after.velocities[rows],
            "calls": [(p, f[rows]) for p, f in calls]}


def judge_step(step: dict, masses, rows, config: dict) -> dict:
    """The reference's step from the same state, and the check's numbers."""
    G, soft, dt = config["G"], config["softening"], config["dt"]
    ref = reference.leapfrog_rows(step["x0"], step["v0"], masses,
                                  step["x1_all"], rows, dt, G, soft)
    forces = []
    for pos, f in step["calls"]:
        if pos is step["x0"] or torch.equal(pos, step["x0"]):
            want = ref["forces0"]
        elif pos is step["x1_all"] or torch.equal(pos, step["x1_all"]):
            want = ref["forces1"]
        else:
            want = reference.forces_on_rows(pos, masses, rows, G, soft)
        forces.append((f, want))
    return check.step_numbers(forces, step["x1"], step["v1"], ref, dt)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read ({exc})"
    return out.stdout.strip().replace("\n", "; ")


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device_type: str = "cuda", n: Optional[int] = None,
             started: Optional[float] = None) -> dict:
    """Run the cell once; return the result (the last line's object).

    ``n`` replaces the configuration's N and ``device_type`` the card (the
    CPU tests); ``started`` is the time set-up counts from (by default the
    start of this process)."""
    started = PROCESS_START if started is None else started
    cell, config, mix = catalog.cell(name)
    if mix["integrator"] != "leapfrog":
        raise ValueError("the check's reference steps by leapfrog only, "
                         f"not {mix['integrator']!r}")
    bench = catalog.spec()
    chips = int(cell["chips"])
    devices = cell_devices(device_type, chips)

    def sync():
        if device_type == "cuda":
            for d in devices:
                torch.cuda.synchronize(d)

    bodies = inputs.make_bodies(config, seed, devices[0], n=n)
    masses = bodies[2]
    rec = RunRecord(name, cell, config, mix, chips, *bodies[0].shape)
    rows = inputs.sample_rows(rec.n, cell["check"]["rows"], seed).to(
        devices[0])
    section = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: (m, catalog.reader(
        "metrics" if trace else "end_to_end", m["name"]))
        for m in catalog.metrics_of(name, section, bench)}

    sim, mesh = build_simulation(config, mix, bodies, devices)
    probe = ForceProbe(sim.forces_fn, sync)
    sim = dataclasses.replace(sim, forces_fn=probe)
    dt = float(config["dt"])

    # Set-up: the warm-up steps; the first is checked from the bodies.
    census = mesh.census() if mesh is not None else contextlib.nullcontext()
    before, probe.record = sim.system, []
    with census as collectives:
        sim = sim.run(steps=1, dt=dt)
        sync()
    checked = [_checked_step(before, probe.record, sim.system, rows)]
    probe.record = None
    for _ in range(int(mix.get("warmup_steps", 1)) - 1):
        sim = sim.run(steps=1, dt=dt)
    sync()
    if collectives is not None:
        log(f"census of one warm-up step on {chips} shards: {collectives}")
    rec.setup_s = time.perf_counter() - started

    # The window.
    for key, (_, mod) in readers.items():
        if hasattr(mod, "snapshot"):
            rec.snapshots[key] = [mod.snapshot(), None]
    calls0 = probe.calls
    prof = None
    if trace:
        probe.spans = []
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    while True:
        before, probe.record = sim.system, []
        n_spans = len(probe.spans) if trace else 0
        t = time.perf_counter()
        with (torch.profiler.record_function("bench::step") if trace
              else contextlib.nullcontext()):
            sim = sim.run(steps=1, dt=dt)
            sync()
        took = time.perf_counter() - t
        rec.steps += 1
        if trace:
            rec.step_spans.append((took, probe.spans[n_spans:],
                                   rec.steps <= TRACE_STEPS))
            if rec.steps == TRACE_STEPS:
                prof.__exit__(None, None, None)
        if time.perf_counter() - t0 >= seconds:
            break
    rec.window_s = time.perf_counter() - t0
    rec.force_calls = probe.calls - calls0
    for key, (_, mod) in readers.items():
        if key in rec.snapshots:
            rec.snapshots[key][1] = mod.snapshot()
    checked.append(_checked_step(before, probe.record, sim.system, rows))
    final = (sim.system.positions, sim.system.velocities)
    del sim, probe, before
    memory_peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
                      default=0) if device_type == "cuda" else 0

    if prof is not None:
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            rec.trace = tracing.reduce_trace(path, chips)
            if rec.trace is not None:
                kinds = collections.Counter(
                    f"{e.cat}:{e.name[:40]}" for e in rec.trace.events
                    if e.cat != "kernel")
                log(f"trace: {rec.trace.steps} steps, "
                    f"{len(rec.trace.kernels())} kernels, "
                    f"{len(rec.trace.force_calls)} force calls, other "
                    f"device events {dict(kinds)}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del prof

    metrics = {}
    for key, (entry, mod) in readers.items():
        value = mod.read(rec)
        if value is not None:
            metrics[key] = {"value": value, "unit": entry["unit"]}

    # The check, once the window's state is freed.
    readings = [judge_step(step, masses, rows, config) for step in checked]
    del checked
    correct, checks = check.judge(check.worst(readings),
                                  cell["check"]["limits"])
    failed = sum(not check.judge(r, cell["check"]["limits"])[0]
                 for r in readings)
    if rec.n <= ENERGY_MAX_N:
        G, soft = config["G"], config["softening"]
        e0 = (reference.kinetic_energy(bodies[1], masses)
              + reference.potential_energy(bodies[0], masses, G, soft))
        e1 = (reference.kinetic_energy(final[1], masses)
              + reference.potential_energy(final[0], masses, G, soft))
        log(f"energy: {e0!r} -> {e1!r} after {rec.steps + 1} steps, "
            f"relative drift {(e1 - e0) / abs(e0)!r}")

    device = {"platform": "gpu" if device_type == "cuda" else device_type,
              "kind": (torch.cuda.get_device_name(0) if device_type == "cuda"
                       else device_type),
              "count": chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct,
              "attempted": rec.steps + int(mix.get("warmup_steps", 1)),
              "failed": failed, "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.mean_busy_us() / 1e6
        device["window_s"] = rec.trace.window_us / 1e6
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps}
    log(f"{name} seed {seed}: {rec.steps} steps in {rec.window_s!r} s, "
        f"{rec.force_calls} force calls, set-up {rec.setup_s!r} s, "
        f"peak memory {memory_peak} bytes, checked rows {rows.numel()}")
    result["checks"] = checks
    return result


def _port_beside(root: Path) -> Optional[str]:
    """Where the port was imported from, unless it lies in ``root``."""
    try:
        import nbody_tpu_torch
    except ImportError as exc:
        return f"the port does not import: {exc}"
    where = Path(nbody_tpu_torch.__file__).resolve()
    if root not in where.parents:
        return f"the port was imported from {where}, not from {root}"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    problem = _port_beside(ROOT)
    if problem:
        log(problem)
        return 2
    chips = int(catalog.load("workloads", args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 2
    log(f"cards: {nvidia_smi()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"refused: the process loaded {loaded}")
        return 3
    print(json.dumps(result), flush=True)
    for key, c in result["checks"].items():
        log(f"check {key}: {c['value']!r} (limit {c['limit']!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
