"""The program's own spans and counters (``nbody_tpu_torch.utils.profiling``),
for the per-layer readers that read them.

A reader's ``snapshot()`` turns the spans on (they are off by default, and
the harness takes snapshots only in a traced run, so the timed runs carry
none) and returns the registry: every span's (seconds, calls), the same of
the spans opened while no profiler was recording, and the counters. A
program without spans gives ``None``, and the reader leaves its metric out.
A CUDA span is timed by two events on the device's stream; the window's
last step ends in a synchronize, so its events are complete when the
closing snapshot reads them.

Times are read from the steps the profiler did not slow (the window's first
step is profiled), and from all of them where every step was, as the
harness's ``force_call_ms`` reads its own spans.
"""

from __future__ import annotations

from typing import Optional, Tuple


def snapshot() -> Optional[dict]:
    try:
        from nbody_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "enable_spans"):
        return None
    profiling.enable_spans()
    return {"all": profiling.span_totals(),
            "outside": profiling.span_totals(outside_profiler=True),
            "counters": profiling.counter_totals()}


def _delta(w, part: str, name: str):
    start, end = (snap[part].get(name, (0.0, 0) if part != "counters"
                                 else 0) for snap in w)
    if part == "counters":
        return end - start
    return end[0] - start[0], end[1] - start[1]


def window(run, key: str):
    """The reader ``key``'s (start, end) snapshots; None where one is
    missing."""
    w = run.snapshots.get(key)
    if w is None or None in w:
        return None
    return w


def per(run, key: str, name: str, unit: str) -> Optional[Tuple[float, int]]:
    """(seconds of span ``name``, calls of span ``unit``) over the window,
    from the spans outside the profiler where ``unit`` ran there, else from
    all; None where a snapshot is missing or ``unit`` never ran."""
    w = window(run, key)
    if w is None:
        return None
    for part in ("outside", "all"):
        calls = _delta(w, part, unit)[1]
        if calls:
            return _delta(w, part, name)[0], calls
    return None


def ran(run, key: str, name: str) -> bool:
    """Whether span ``name`` ran in the window."""
    w = window(run, key)
    return w is not None and _delta(w, "all", name)[1] > 0


def counted(run, key: str, name: str) -> Optional[int]:
    """Counter ``name``'s growth over the window; None where a snapshot is
    missing."""
    w = window(run, key)
    return None if w is None else _delta(w, "counters", name)


def ms_per_call(run, key: str, name: str) -> Optional[float]:
    """Milliseconds of span ``name`` a force call (``sim.force``); None
    where it never ran in the window."""
    got = per(run, key, name, "sim.force")
    if got is None or not ran(run, key, name):
        return None
    return 1e3 * got[0] / got[1]


def bvh_count_per_call(run, key: str, name: str) -> Optional[float]:
    """Counter ``name``'s growth over the window's force calls; None where
    a snapshot is missing or the BVH never ran in the window (no
    ``bvh.build``), 0 where it ran without adding to the counter."""
    grew = counted(run, key, name)
    if grew is None or not run.force_calls or not ran(run, key, "bvh.build"):
        return None
    return grew / run.force_calls
