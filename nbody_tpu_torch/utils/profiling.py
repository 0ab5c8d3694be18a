"""Profiling: per-phase timing and device traces (port of
``nbody_tpu.utils.profiling``).

The reference's only instrumentation is a wall-clock wrapper per method
(``utils.h:88-104``). Here:

* :class:`PhaseTimer` — named phases timed on the device they run on: CUDA
  events on a CUDA device (the end event is waited for before the clock is
  read), ``perf_counter`` on the CPU; reported as a table.
* :func:`trace` — ``torch.profiler`` around a block (CPU activity, and CUDA
  activity where a card is visible), written as a Chrome trace into a
  directory, when one is given.
* :func:`phase_breakdown_fmm` — the FMM's capacity scan, tree build and
  evaluation, each timed alone.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulate named phase times (seconds) on ``device``; print a
    table. Every phase ends with the device's work done."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _add(self, name: str, seconds: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                try:
                    yield
                finally:
                    end.record()
                    end.synchronize()
                    self._add(name, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs):
        with self.phase(name):
            return fn(*args, **kwargs)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'phase':<24} {'time':>10} {'calls':>6} {'%':>6}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(
                f"{name:<24} {t:>9.4f}s {self.counts[name]:>6} {pct:>5.1f}%")
        lines.append(f"{'total':<24} {total:>9.4f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """``torch.profiler`` trace of the block, written to
    ``<trace_dir>/trace.json`` (Chrome trace format); yields the profiler,
    or None and records nothing when ``trace_dir`` is None."""
    if trace_dir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def phase_breakdown_fmm(positions, masses, config=None, order: int = 5,
                        timer: Optional[PhaseTimer] = None) -> PhaseTimer:
    """Time the FMM's capacity scan, tree build and evaluation (P2M to P2P,
    the near field as ``fmm_forces`` runs it: ``p2p_impl="auto"``) on the
    bodies' device."""
    from ..config import DEFAULT_GRAVITY
    from ..ops.fmm import fmm_accel_sorted
    from ..ops.grid_tree import (auto_leaf_level, build_grid_tree,
                                 compute_capacity)

    config = config or DEFAULT_GRAVITY
    timer = timer or PhaseTimer(positions.device)
    n, dim = positions.shape
    leaf_level = auto_leaf_level(n, dim)
    capacity = timer.timed("capacity_scan", compute_capacity,
                           positions, leaf_level)
    tree = timer.timed("tree_build", build_grid_tree, positions, masses,
                       leaf_level, capacity)
    timer.timed("fmm_eval(P2M..P2P)", fmm_accel_sorted, tree, order=order,
                softening=float(config.softening), p2p_impl="auto")
    return timer
