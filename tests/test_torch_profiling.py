"""The port's profiling helpers (nbody_tpu_torch.utils.profiling) on the
CPU: PhaseTimer (perf_counter on the CPU; CUDA events only on a card),
trace() as a no-op and as a torch.profiler Chrome trace, the FMM's
three-phase breakdown (the phases of tests/test_profiling.py), and the
program's spans and counters: off by default, on in the BVH's and the
FMM's phases, named in a Chrome trace, never changing a result."""

import json
import time

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import GravityConfig
from nbody_tpu_torch.ops import bvh as tb
from nbody_tpu_torch.simulation import Simulation
from nbody_tpu_torch.state import random_system
from nbody_tpu_torch.utils import profiling
from nbody_tpu_torch.utils.profiling import PhaseTimer, phase_breakdown_fmm

# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)

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


# --- spans and counters inside the program ----------------------------------


@pytest.fixture
def spans():
    """The registry empty and the spans off before and after the test, so
    that no test leaks spans into another."""
    profiling.reset_spans()
    yield profiling
    profiling.reset_spans()


def _clustered(n, frac, dim=3, seed=0):
    """``frac`` of the bodies in a 1e-3-wide ball at 0.5, the rest in
    [0, 1]^D, unit masses (tests/test_torch_bvh.py's escalating input)."""
    rng = np.random.default_rng(seed)
    nc = int(n * frac)
    pos = np.concatenate([0.5 + 1e-3 * rng.uniform(0, 1, (nc, dim)),
                          rng.uniform(0, 1, (n - nc, dim))])
    return torch.from_numpy(pos), torch.ones(n, dtype=torch.float64)


ESCALATING = dict(theta=0.5, group_size=32, frontier_width=16, near_cap=16,
                  max_escalations=8)
UNIT = GravityConfig(G=1.0, softening=1e-4)


def _trace_names(path):
    events = json.loads(path.read_text())["traceEvents"]
    return {e.get("name") for e in events}


def _small_system(method, n=300):
    s = random_system(n, 3, generator=torch.Generator().manual_seed(1),
                      device=CPU, dtype=torch.float64)
    return Simulation.create(s, GravityConfig(G=1.0, softening=0.1),
                             method=method)


def test_spans_off_by_default_leave_no_trace(spans, tmp_path, monkeypatch):
    """Off, no call site makes a span (the span class is replaced by one
    that raises), the registry stays empty and the profiler's trace holds
    no ``nbody::`` name."""
    assert not spans.spans_enabled()

    def refuse(*args):
        raise AssertionError(f"a span was made while spans are off: {args}")

    monkeypatch.setattr(profiling, "_Span", refuse)
    sim = _small_system("bvh")
    with profiling.trace(str(tmp_path / "tr")):
        sim.run(steps=1, dt=1e-3)
    assert spans.span_totals() == {} and spans.counter_totals() == {}
    names = _trace_names(tmp_path / "tr" / "trace.json")
    assert names and not any(str(n).startswith("nbody::") for n in names)
    assert profiling.spanned("sim.force", torch.ones) is torch.ones


def test_bvh_spans_on_an_escalating_input(spans):
    pos, mass = _clustered(2000, 0.9, seed=3)
    spans.enable_spans()
    tb.bvh_forces(pos, mass, UNIT, **ESCALATING)
    totals, counters = spans.span_totals(), spans.counter_totals()
    assert {"bvh.build", "bvh.frontier", "bvh.near",
            "bvh.rewalk"} <= set(totals)
    assert totals["bvh.build"][1] == 1
    assert totals["bvh.rewalk"][1] >= 1
    assert counters["bvh.escalations"] == totals["bvh.rewalk"][1]
    # One frontier loop and one pass 2 a batch: the first walk's and each
    # re-walk's.
    assert totals["bvh.frontier"][1] == totals["bvh.near"][1] \
        >= 1 + totals["bvh.rewalk"][1]
    assert counters["bvh.walk_iters"] >= totals["bvh.frontier"][1]
    # Each round re-walks the padded subset, a power of two of groups.
    per_round = counters["bvh.rewalk_groups"] // counters["bvh.escalations"]
    assert per_round & (per_round - 1) == 0
    assert all(s >= 0 for s, _ in totals.values())


def test_bvh_forces_bit_identical_with_spans_on(spans):
    pos, mass = _clustered(2000, 0.9, seed=3)
    off = tb.bvh_forces(pos, mass, UNIT, **ESCALATING)
    spans.enable_spans()
    on = tb.bvh_forces(pos, mass, UNIT, **ESCALATING)
    assert torch.equal(on, off)
    assert spans.span_totals()["bvh.rewalk"][1] >= 1


def test_bvh_span_names_in_a_chrome_trace(spans, tmp_path):
    spans.enable_spans()
    sim = _small_system("bvh")
    with profiling.trace(str(tmp_path / "tr")):
        sim.run(steps=1, dt=1e-3)
    names = _trace_names(tmp_path / "tr" / "trace.json")
    assert {"nbody::sim.step", "nbody::sim.force", "nbody::bvh.build",
            "nbody::bvh.frontier", "nbody::bvh.near"} <= names
    # Opened under the profiler: in the totals, not in those outside it.
    assert spans.span_totals()["sim.step"] == (
        spans.span_totals()["sim.step"][0], 1)
    assert spans.span_totals(outside_profiler=True) == {}
    sim.run(steps=1, dt=1e-3)
    assert spans.span_totals(outside_profiler=True)["sim.step"][1] == 1
    assert spans.span_totals()["sim.step"][1] == 2


FMM_SPANS = {"fmm.build", "fmm.upward", "fmm.m2l", "fmm.downward",
             "fmm.p2p"}


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_fmm_spans_and_reads(spans, layout):
    """Each FMM phase's span once a call (``fmm.downward`` twice: L2L,
    then L2P), the counter ``fmm.reads`` at the call's host read-backs
    (the capacity scan; on the sparse layout the grid's sizes and each
    chunk batch's window table), and the same bits with spans on and
    off."""
    from nbody_tpu_torch.ops import fmm, sparse_grid
    pos, mass = _clustered(3000, 0.6 if layout == "sparse" else 0.0,
                           seed=4)
    pos, mass = pos.float(), mass.float()
    off = fmm.fmm_forces(pos, mass, UNIT, order=4)
    assert spans.span_totals() == {} and spans.counter_totals() == {}
    spans.enable_spans()
    on = fmm.fmm_forces(pos, mass, UNIT, order=4)
    assert torch.equal(on, off)
    totals = spans.span_totals()
    assert set(totals) == FMM_SPANS
    assert {k: c for k, (_, c) in totals.items()} == {
        "fmm.build": 1, "fmm.upward": 1, "fmm.m2l": 1, "fmm.downward": 2,
        "fmm.p2p": 1}
    assert all(t >= 0 for t, _ in totals.values())
    reads = 1
    if layout == "sparse":
        num_chunks, _ = sparse_grid.sparse_grid_stats(pos, 2, 64, 8, 1)
        reads += 1 + -(-num_chunks // min(1024, 128, num_chunks))
    assert spans.counter_totals() == {"fmm.reads": reads}


def test_spans_nest_and_reset(spans):
    spans.enable_spans()
    with spans.span("outer"):
        with spans.span("inner"):
            time.sleep(0.005)
        with spans.span("inner"):
            pass
    spans.count("things", 3)
    spans.count("things")
    totals = spans.span_totals()
    assert totals["outer"][1] == 1 and totals["inner"][1] == 2
    assert totals["outer"][0] >= totals["inner"][0] >= 0.005
    assert spans.counter_totals() == {"things": 4}
    spans.reset_spans()
    assert not spans.spans_enabled()
    assert spans.span_totals() == {} and spans.counter_totals() == {}
    spans.count("things")
    with spans.span("outer"):
        pass
    assert spans.span_totals() == {} and spans.counter_totals() == {}
