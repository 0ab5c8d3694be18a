"""The port's profiling helpers (nbody_tpu_torch.utils.profiling) on the
CPU: PhaseTimer (perf_counter on the CPU; CUDA events only on a card),
trace() as a no-op and as a torch.profiler Chrome trace, and the FMM's
three-phase breakdown (the phases of tests/test_profiling.py)."""

import json
import time

import torch

from nbody_tpu_torch.state import random_system
from nbody_tpu_torch.utils import profiling
from nbody_tpu_torch.utils.profiling import PhaseTimer, phase_breakdown_fmm

CPU = torch.device("cpu")


def test_phase_timer_basic():
    t = PhaseTimer(CPU)
    with t.phase("a"):
        time.sleep(0.01)
    out = t.timed("b", lambda: torch.arange(8.0))
    out2 = t.timed("b", torch.ones, 3)
    assert out.shape == (8,) and out2.shape == (3,)
    rep = t.report()
    assert "a" in rep and "b" in rep and "total" in rep
    assert t.counts == {"a": 1, "b": 2}
    assert t.times["a"] >= 0.01


def test_trace_none_is_a_no_op():
    with profiling.trace(None) as prof:
        torch.ones(4).sum()
    assert prof is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (torch.rand(64, 64) @ torch.rand(64, 64)).sum()
    assert prof is not None
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names


def test_fmm_breakdown_on_the_cpu():
    s = random_system(500, 2, generator=torch.Generator().manual_seed(0),
                      device=CPU)
    timer = phase_breakdown_fmm(s.positions, s.masses, order=3)
    assert timer.device == CPU
    assert set(timer.times) == {"capacity_scan", "tree_build",
                                "fmm_eval(P2M..P2P)"}
    assert all(v >= 0 for v in timer.times.values())
    assert "fmm_eval" in timer.report()
