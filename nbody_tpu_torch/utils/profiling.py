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
* :func:`span` and :func:`count` — spans and counters at the program's own
  phase boundaries (``Simulation.run``'s steps, force calls and carried
  evaluations, the BVH's build, frontier walk, pass 2 and escalation
  re-walks, the ring's per-card self blocks and tiles, the FMM's build,
  upward pass, M2L, downward pass and near field with its host
  read-backs), off by default.
  :func:`enable_spans` turns them on for the rest of the process; each span
  then adds its time to a module-level registry, on the device's clock: a
  new start and end CUDA event on the current stream of a CUDA device,
  held until :func:`span_totals` reads them (a span never synchronizes),
  else ``perf_counter``. While a ``torch.profiler`` records, a span also
  opens a ``torch.profiler.record_function("nbody::<name>")``, named in
  the trace beside the device's events, and its time is kept apart, since
  the profiler slows what it watches. Off, a span is one flag check and a
  shared no-op context, and a counter one flag check.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Tuple

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


# Spans and counters: one registry for the process, off by default.
_SPANS_ON = False
# name -> [seconds, calls] of the spans opened while no torch.profiler was
# recording, and of those opened under one.
_SPAN_TOTALS: Dict[str, list] = {}
_PROFILED: Dict[str, list] = {}
_COUNTERS: Dict[str, object] = {}  # int, or a device tensor
# CUDA spans not yet resolved: (name, profiled, start event, end event).
_PENDING: list = []
_OFF = contextlib.nullcontext()


def enable_spans() -> None:
    """Turn spans and counters on for the rest of the process."""
    global _SPANS_ON
    _SPANS_ON = True


def spans_enabled() -> bool:
    return _SPANS_ON


def reset_spans() -> None:
    """Turn spans and counters off and empty the registry."""
    global _SPANS_ON
    _SPANS_ON = False
    for registry in (_SPAN_TOTALS, _PROFILED, _COUNTERS, _PENDING):
        registry.clear()


def _add(name: str, profiled: bool, seconds: float, calls: int) -> None:
    total = (_PROFILED if profiled else _SPAN_TOTALS).setdefault(
        name, [0.0, 0])
    total[0] += seconds
    total[1] += calls


class _Span:
    __slots__ = ("name", "stream", "annotation", "profiled", "start")

    def __init__(self, name: str, device):
        self.name = name
        device = torch.device(device) if device is not None else None
        self.stream = torch.cuda.current_stream(device) \
            if device is not None and device.type == "cuda" else None

    def __enter__(self):
        # The annotation names the span in a profiler's trace; with no
        # profiler recording it would name nothing, so none is opened.
        self.profiled = torch.autograd._profiler_enabled()
        self.annotation = torch.profiler.record_function(
            f"nbody::{self.name}") if self.profiled else None
        if self.annotation is not None:
            self.annotation.__enter__()
        if self.stream is None:
            self.start = time.perf_counter()
        else:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.stream is None:
            _add(self.name, self.profiled,
                 time.perf_counter() - self.start, 1)
        else:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _add(self.name, self.profiled, 0.0, 1)
            _PENDING.append((self.name, self.profiled, self.start, end))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, device=None):
    """Context manager: the block's time under ``name``, on ``device``'s
    clock (CUDA events on a CUDA device, else ``perf_counter``). Spans
    nest; each name keeps its own total. Off: a shared no-op context."""
    if not _SPANS_ON:
        return _OFF
    return _Span(name, device)


def spanned(name: str, fn: Callable, device=None) -> Callable:
    """``fn`` with each call in :func:`span` ``name``; ``fn`` itself while
    spans are off."""
    if not _SPANS_ON:
        return fn

    def call(*args, **kwargs):
        with span(name, device):
            return fn(*args, **kwargs)
    return call


def count(name: str, k=1) -> None:
    """Add ``k`` to the counter ``name`` (nothing while spans are off).
    ``k`` may be an integer tensor on the device: it is added there, with
    no read-back, and read when :func:`counter_totals` is."""
    if _SPANS_ON:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + k


def span_totals(outside_profiler: bool = False
                ) -> Dict[str, Tuple[float, int]]:
    """name -> (seconds, calls) of every span so far, CUDA spans resolved
    (a wait only for those whose work is still queued). With
    ``outside_profiler``, only the spans opened while no
    ``torch.profiler`` was recording: a profiler slows the program it
    watches, so these are the unperturbed times."""
    for name, profiled, start, end in _PENDING:
        end.synchronize()
        _add(name, profiled, start.elapsed_time(end) / 1e3, 0)
    _PENDING.clear()
    out = {name: tuple(t) for name, t in _SPAN_TOTALS.items()}
    if not outside_profiler:
        for name, (seconds, calls) in _PROFILED.items():
            seconds0, calls0 = out.get(name, (0.0, 0))
            out[name] = (seconds0 + seconds, calls0 + calls)
    return out


def counter_totals() -> Dict[str, int]:
    """name -> total of every counter so far (a wait for the device where
    a counter was added there)."""
    return {name: int(k) for name, k in _COUNTERS.items()}
