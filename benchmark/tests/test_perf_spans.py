"""The readers of the program's own spans and counters
(``benchmark/spans.py``): a traced run reports them, an untraced run leaves
the spans off, and a program without spans leaves the metrics out."""

import pytest

from benchmark import catalog, run

from conftest import SEED, SMALL_N

BVH = "plummer3d_1e5.bvh_leapfrog"
BRUTE = "uniform2d_1m.brute_leapfrog"
BVH_SPANS = ["bvh_build_ms", "bvh_frontier_ms", "bvh_near_ms",
             "bvh_rewalk_ms", "bvh_escalations_per_call",
             "bvh_walk_iters_per_call", "bvh_rewalk_groups_per_call"]


@pytest.fixture(autouse=True)
def spans_off():
    from nbody_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_traced_bvh_run_reports_the_program_spans():
    res = run.run_cell(BVH, SEED, 0.2, True, device_type="cpu", n=SMALL_N)
    metrics = res["metrics"]
    for name in BVH_SPANS + ["integrator_ms"]:
        assert name in metrics, name
        assert metrics[name]["value"] >= 0
    assert metrics["integrator_ms"]["unit"] == "ms"
    # The walk's phases lie inside the force call the harness times.
    inner = sum(metrics[k]["value"] for k in BVH_SPANS[:3])
    assert 0 < inner <= metrics["force_call_ms"]["value"] * 1.05
    # Each frontier iteration ends in one of the tier's host read-backs.
    iters = metrics["bvh_walk_iters_per_call"]["value"]
    assert 1 <= iters <= metrics["bvh_reads_per_call"]["value"]


def test_traced_brute_run_reports_integrator_ms_alone():
    res = run.run_cell(BRUTE, SEED, 0.1, True, device_type="cpu", n=SMALL_N)
    assert "integrator_ms" in res["metrics"]
    assert not set(BVH_SPANS) & set(res["metrics"])


@pytest.mark.parametrize("cell", [BVH, BRUTE])
def test_untraced_run_leaves_spans_off(cell):
    from nbody_tpu_torch.utils import profiling
    run.run_cell(cell, SEED, 0.1, False, device_type="cpu", n=SMALL_N)
    assert not profiling.spans_enabled()
    assert profiling.span_totals() == {}
    assert profiling.counter_totals() == {}


@pytest.mark.parametrize("name", BVH_SPANS + ["integrator_ms"])
def test_without_spans_in_the_program_nothing_is_read(name, monkeypatch):
    """The parent program has no spans: its snapshots are None, and the
    reader leaves the metric out without raising."""
    from nbody_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "enable_spans")
    mod = catalog.reader("metrics", name)
    rec = run.RunRecord(name, {}, {}, {}, 1, 10, 3, steps=2, force_calls=4)
    rec.snapshots[name] = [mod.snapshot(), mod.snapshot()]
    assert rec.snapshots[name] == [None, None]
    assert mod.read(rec) is None


def _snap(outside, profiled=None, counters=None):
    every = dict(outside)
    for k, (s, c) in (profiled or {}).items():
        s0, c0 = every.get(k, (0.0, 0))
        every[k] = (s0 + s, c0 + c)
    return {"all": every, "outside": outside, "counters": counters or {}}


def _record(name, start, end, force_calls=2, steps=1):
    rec = run.RunRecord(BVH, {}, {}, {}, 1, 10, 3, steps=steps,
                        force_calls=force_calls)
    rec.snapshots[name] = [start, end]
    return rec


def test_readers_take_the_steps_outside_the_profiler():
    """The profiled step's spans are left out where later steps ran outside
    the profiler, and read where every step was profiled."""
    mod = catalog.reader("metrics", "bvh_near_ms")
    start = _snap({})
    end = _snap({"sim.force": (3.0, 2), "bvh.near": (1.0, 2)},
                {"sim.force": (9.0, 2), "bvh.near": (5.0, 2)})
    assert mod.read(_record("bvh_near_ms", start, end, 4)) == 500.0
    end = _snap({}, {"sim.force": (9.0, 2), "bvh.near": (5.0, 2)})
    assert mod.read(_record("bvh_near_ms", start, end)) == 2500.0
    step = catalog.reader("metrics", "integrator_ms")
    end = _snap({"sim.step": (3.5, 1), "sim.force": (3.0, 2)},
                {"sim.step": (10.0, 1), "sim.force": (9.0, 2)})
    assert step.read(_record("integrator_ms", start, end, 4, 2)) == 500.0


def test_bvh_readers_read_zero_rewalks_where_the_bvh_ran_without_them():
    start = _snap({}, counters={"bvh.escalations": 4})
    end = _snap({"sim.force": (3.0, 2), "bvh.build": (0.1, 2)},
                counters={"bvh.escalations": 4})
    for name in ("bvh_rewalk_ms", "bvh_escalations_per_call",
                 "bvh_rewalk_groups_per_call"):
        rec = _record(name, start, end)
        assert catalog.reader("metrics", name).read(rec) == 0
    # No build in the window: nothing to read.
    end = _snap({"sim.force": (3.0, 2)}, counters={"bvh.escalations": 4})
    for name in BVH_SPANS:
        rec = _record(name, start, end)
        assert catalog.reader("metrics", name).read(rec) is None


@pytest.mark.parametrize("name, counter", [
    ("bvh_escalations_per_call", "bvh.escalations"),
    ("bvh_walk_iters_per_call", "bvh.walk_iters"),
    ("bvh_rewalk_groups_per_call", "bvh.rewalk_groups")])
def test_bvh_counters_read_over_the_force_calls(name, counter):
    """A counter's growth over the window, over the window's force calls."""
    start = _snap({}, counters={counter: 10})
    end = _snap({"sim.force": (3.0, 4), "bvh.build": (0.1, 4)},
                counters={counter: 130})
    rec = _record(name, start, end, force_calls=4)
    assert catalog.reader("metrics", name).read(rec) == 30
