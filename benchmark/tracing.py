"""The device trace of a traced run, reduced to what the readers need.

``torch.profiler`` (CPU and CUDA activity) records the profiled steps; its
Chrome trace is written to a temporary directory under ``TMPDIR``, read
here and deleted. The harness marks each step and each force call with a
``bench::step`` / ``bench::force_call`` annotation, which lands in the same
time base as the device's events. Everything is in microseconds.

Busy time is the union of a card's kernel, copy and set intervals, so work
on two streams at once is not counted twice. Idle gaps are named by the
innermost host operation that was running on the harness's thread at the
gap's midpoint.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

Interval = Tuple[float, float]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 96


@dataclasses.dataclass
class DeviceEvent:
    device: int
    start: float
    end: float
    cat: str
    name: str


@dataclasses.dataclass
class TraceSummary:
    """The profiled stretch: from the first ``bench::step`` to the end of
    the last."""

    start: float
    end: float
    cards: int
    events: List[DeviceEvent]  # kernels, copies and sets in the stretch
    force_calls: List[Interval]
    steps: int
    idle_gaps: list  # [name, seconds averaged over the cards]

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def kernels(self) -> List[DeviceEvent]:
        return [e for e in self.events if e.cat == "kernel"]

    def busy_us(self, device: int, cats=DEVICE_CATS,
                span: Optional[Interval] = None) -> float:
        lo, hi = span or (self.start, self.end)
        return union_length([(max(e.start, lo), min(e.end, hi))
                             for e in self.events
                             if e.device == device and e.cat in cats
                             and e.end > lo and e.start < hi])

    def mean_busy_us(self) -> float:
        return sum(self.busy_us(d) for d in range(self.cards)) / self.cards

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time, [name, seconds summed
        over the cards]."""
        total: Dict[str, float] = collections.Counter()
        for e in self.events:
            total[e.name[:NAME_CHARS]] += (e.end - e.start) / 1e6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def union_length(intervals: List[Interval]) -> float:
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(i for i in intervals if i[1] > i[0]):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def _gaps(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def _innermost(host: List[Tuple[float, float, str]],
               points: List[float]) -> List[str]:
    """For each time in ``points`` (sorted), the name of the innermost host
    event (properly nested, one thread) that spans it, else "python"."""
    names, stack, i = [], [], 0
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    for p in points:
        while i < len(host) and host[i][0] <= p:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else "python")
    return names


def _device_of(e: dict) -> int:
    dev = e.get("args", {}).get("device")
    return int(dev if dev is not None else e.get("pid", 0))


def reduce_trace(path: str, cards: int, top: int = 10) -> Optional[TraceSummary]:
    """The summary of a Chrome trace at ``path``, or None if it holds no
    ``bench::step`` annotation."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "bench::step"]
    if not steps:
        return None
    start = min(float(e["ts"]) for e in steps)
    end = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    main_tid = steps[0].get("tid")
    dev_events, host = [], []
    for e in events:
        cat = str(e.get("cat", "")).lower()
        ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            if te > start and ts < end:
                dev_events.append(DeviceEvent(_device_of(e), ts, te, cat,
                                              e["name"]))
        elif cat in HOST_CATS and e.get("tid") == main_tid:
            host.append((ts, te, e["name"]))
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"] == "bench::force_call"
                   and float(e["ts"]) >= start and float(e["ts"]) < end)
    summary = TraceSummary(start, end, cards, dev_events, calls, len(steps),
                           [])
    gap_time: Dict[str, float] = collections.Counter()
    for d in range(cards):
        busy = [(max(e.start, start), min(e.end, end)) for e in dev_events
                if e.device == d]
        gaps = _gaps(busy, start, end)
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        for name, (_, length) in zip(_innermost(host, [m for m, _ in mids]),
                                     mids):
            gap_time[name[:NAME_CHARS]] += length / 1e6 / cards
    summary.idle_gaps = [[k, v] for k, v in sorted(
        gap_time.items(), key=lambda kv: -kv[1])[:top]]
    return summary


def calls_in(summary: TraceSummary) -> List[List[DeviceEvent]]:
    """The device events of each profiled force call: those whose midpoint
    lies inside the call's annotation (each call ends in a synchronize, so
    its work lies inside it)."""
    starts = [c[0] for c in summary.force_calls]
    out: List[List[DeviceEvent]] = [[] for _ in summary.force_calls]
    for e in summary.events:
        mid = (e.start + e.end) / 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid <= summary.force_calls[k][1]:
            out[k].append(e)
    return out
