"""Timing/accuracy harness and dual-sink reporting (PyTorch port of
``nbody_tpu.bench.harness``).

Same CSV schema ``Method,Bodies,Dimension,Time(s)[,Accuracy(%),NormError]``
plus ``Hyperparams`` (``main.cpp:59-63``), same ``safely_execute``
semantics (``utils.h:88-104``: exception containment, −1 sentinel), same
``results/run_<id>_N_<n>_<D>D.{csv,out}`` files. Timing ends with the
forces on the host: :func:`materialize` synchronizes the card first.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import List, Optional, Sequence, TextIO

import numpy as np
import torch

from ..config import DEFAULT_TREE, GravityConfig, TreeConfig
from ..state import System
from ..utils.accuracy import (accuracy_percentage, percentile_relative_error,
                              scale_normalized_error)
from .registry import Method, reference_method_for


def get_run_id(now: Optional[datetime.datetime] = None) -> str:
    """MMDDYYYY_HHMMSS run id (utils.h:67-83 parity)."""
    now = now or datetime.datetime.now()
    return now.strftime("%m%d%Y_%H%M%S")


def ensure_results_directory(path: str = "results") -> str:
    os.makedirs(path, exist_ok=True)
    return path


@dataclasses.dataclass
class MethodResult:
    method: str
    n: int
    dim: int
    time_s: float  # −1.0 on failure (safely_execute parity)
    accuracy_pct: Optional[float] = None
    norm_error: Optional[float] = None  # scale-normalized ‖ΔF‖ (extension)
    error: Optional[str] = None
    hyperparams: Optional[dict] = None  # resolved tier config (provenance)

    def hyper_str(self) -> str:
        """`key=value` pairs joined with ';' (CSV-safe — no commas)."""
        if not self.hyperparams:
            return ""
        return ";".join(f"{k}={v}" for k, v in
                        sorted(self.hyperparams.items()))

    def csv_row(self, with_accuracy: bool) -> str:
        base = f"{self.method},{self.n},{self.dim},{self.time_s:.6f}"
        if with_accuracy:
            acc = "" if self.accuracy_pct is None else f"{self.accuracy_pct:.2f}"
            ne = "" if self.norm_error is None else f"{self.norm_error:.3e}"
            return f"{base},{acc},{ne},{self.hyper_str()}"
        return f"{base},{self.hyper_str()}"


def format_time_s(t: float) -> str:
    """Scientific notation below 1µs, fixed otherwise (main.cpp:160-166)."""
    if 0 <= t < 1e-6:
        return f"{t:.3e}"
    return f"{t:.6f}"


class Tee:
    """Mirror writes to stdout and a log file (main.cpp:41-56 dual sink)."""

    def __init__(self, log_file: Optional[TextIO]):
        self.log_file = log_file

    def __call__(self, msg: str):
        print(msg)
        if self.log_file is not None:
            self.log_file.write(msg + "\n")
            self.log_file.flush()


def materialize(forces: torch.Tensor) -> np.ndarray:
    """Wait for the device, then fetch the forces to the host."""
    if forces.is_cuda:
        torch.cuda.synchronize(forces.device)
    return forces.cpu().numpy()


def safely_execute(log: Tee, name: str, fn, *args, warmup: int = 1):
    """Run ``fn`` with exception containment; return (time_s, result|None).

    Parity: utils.h:88-104 (catch-all, −1 sentinel). ``warmup`` extra
    invocations keep first-call costs (kernel build, allocator growth) out
    of the measured time; warmup=0 is reference-style cold timing.
    """
    try:
        for _ in range(warmup):
            materialize(fn(*args))
        t0 = time.perf_counter()
        result = fn(*args)
        materialize(result)
        elapsed = time.perf_counter() - t0
        return elapsed, result
    except Exception as e:  # noqa: BLE001 — harness must contain anything
        log(f"Error executing {name}: {type(e).__name__}: {e}")
        return -1.0, None


def print_validation_forces(forces: np.ndarray, log: Tee, count: int = 3):
    """3 sampled per-body force vectors (utils.h:139-151 parity)."""
    n = forces.shape[0]
    if n < count:
        return
    stride = n // count
    for i in range(stride - 1, n, stride):
        comps = ", ".join(f"{c:.6g}" for c in forces[i])
        log(f"Body #{i + 1} force: ({comps})")


def run_benchmark(
    system: System,
    methods: Sequence[Method],
    gravity: GravityConfig = GravityConfig(),
    tree: TreeConfig = DEFAULT_TREE,
    compute_accuracy: bool = False,
    run_id: Optional[str] = None,
    results_dir: Optional[str] = "results",
    warmup: int = 1,
) -> List[MethodResult]:
    """Run every method, log timings/accuracy, write CSV + .out files."""
    n, dim = system.n, system.dim
    run_id = run_id or get_run_id()

    csv_file = log_file = None
    if results_dir is not None:
        ensure_results_directory(results_dir)
        base = os.path.join(results_dir, f"run_{run_id}_N_{n}_{dim}D")
        # Never clobber an existing run file: uniquify instead.
        if os.path.exists(base + ".csv") or os.path.exists(base + ".out"):
            suffix = 1
            while os.path.exists(f"{base}_{suffix}.csv") \
                    or os.path.exists(f"{base}_{suffix}.out"):
                suffix += 1
            base = f"{base}_{suffix}"
        csv_file = open(base + ".csv", "w")
        log_file = open(base + ".out", "w")
        header = "Method,Bodies,Dimension,Time(s)"
        if compute_accuracy:
            header += ",Accuracy(%),NormError"
        csv_file.write(header + ",Hyperparams\n")
    log = Tee(log_file)

    try:
        reference_forces = None
        if compute_accuracy:
            ref = reference_method_for(n, system.device)
            log(f"Computing reference forces with {ref.name} ...")
            t, out = safely_execute(log, ref.name, ref.fn, system.positions,
                                    system.masses, gravity, tree,
                                    warmup=warmup)
            if out is None:
                log("Reference force computation failed; accuracy disabled.")
                compute_accuracy = False
            else:
                reference_forces = materialize(out)
                log(f"Reference forces computed in {format_time_s(t)} s")

        results: List[MethodResult] = []
        for method in methods:
            try:
                hp = method.hyperparams(n, dim, gravity, tree)
            except Exception:  # noqa: BLE001 — provenance must never kill a run
                hp = {}
            log(f"\nRunning {method.name} (N={n}, {dim}D) ...")
            if hp:
                log(f"{method.name} hyperparams: "
                    + " ".join(f"{k}={v}" for k, v in sorted(hp.items())))
            t, out = safely_execute(log, method.name, method.fn,
                                    system.positions, system.masses, gravity,
                                    tree, warmup=warmup)
            res = MethodResult(method=method.name, n=n, dim=dim, time_s=t,
                               hyperparams=hp)
            if t < 0:
                res.error = "execution failed"
                log(f"{method.name} FAILED")
            else:
                forces = materialize(out)
                log(f"{method.name} time: {format_time_s(t)} s")
                if compute_accuracy and reference_forces is not None:
                    res.accuracy_pct = float(accuracy_percentage(
                        forces, reference_forces))
                    res.norm_error = float(scale_normalized_error(
                        forces, reference_forces))
                    p99 = float(percentile_relative_error(
                        forces, reference_forces, 99.0))
                    log(f"{method.name} accuracy: {res.accuracy_pct:.2f}% "
                        f"(norm err {res.norm_error:.3e}, "
                        f"p99 rel err {p99:.3e})")
                print_validation_forces(forces, log)
            if csv_file is not None:
                csv_file.write(res.csv_row(compute_accuracy) + "\n")
                csv_file.flush()
            results.append(res)
        return results
    finally:
        if csv_file is not None:
            csv_file.close()
        if log_file is not None:
            log_file.close()
