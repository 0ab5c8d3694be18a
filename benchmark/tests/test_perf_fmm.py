"""The FMM cells (``plummer3d_1e5.fmm_leapfrog``,
``uniform3d_4m.fmm_leapfrog``) on the CPU at a small N through
``run_cell``, their readers of the program's ``fmm.*`` spans and counter,
and ``benchmark/fmm_work.py``'s count of M2L's useful pairs against a
brute enumeration."""

import itertools
import math

import numpy as np
import pytest

from benchmark import catalog, fmm_work, run

from conftest import SEED

FMM_CELLS = ["plummer3d_1e5.fmm_leapfrog", "uniform3d_4m.fmm_leapfrog"]
# Bodies of the CPU runs: leaf level 2, so M2L runs, on the dense layout.
FMM_N = 3000
FMM_SPANS = ["fmm_build_ms", "fmm_upward_ms", "fmm_m2l_ms",
             "fmm_downward_ms", "fmm_p2p_ms"]
FMM_READERS = FMM_SPANS + ["fmm_reads_per_call", "m2l_roofline"]


@pytest.fixture(autouse=True)
def spans_off():
    from nbody_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_fmm_cells_are_declared():
    """The 4e6 cell is in ``BENCHMARK.json`` and its files agree with its
    entry; the Plummer cell has files only (its step spread is wider than
    ``step_ms``'s bound allows). Both hold ``force_err`` to the
    deployment's 1e-4, and every FMM metric reads the declared cell."""
    bench = catalog.spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert FMM_CELLS[1] in cells and FMM_CELLS[0] not in cells
    for name in FMM_CELLS:
        cell, config, mix = catalog.cell(name)
        assert cell["config"] == config["name"] and cell["mix"] == mix["name"]
        assert (mix["method"], mix["forces"]) == ("fmm", "simulation")
        assert cell["check"]["limits"]["force_err"] <= 1e-4
    declared = cells[FMM_CELLS[1]]
    assert (declared["config"], declared["traffic"]) == ("uniform3d_4m",
                                                         "fmm_leapfrog")
    for name in FMM_READERS:
        entry, = [m for m in bench["per_layer"] if m["name"] == name]
        assert entry["workloads"] == [FMM_CELLS[1]]


@pytest.mark.parametrize("cell", FMM_CELLS)
def test_fmm_cell_runs_through_simulation_run(cell):
    from nbody_tpu_torch.utils import profiling
    res = run.run_cell(cell, SEED, 0.1, False, device_type="cpu", n=FMM_N)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["metrics"]["step_ms"]["value"] > 0
    assert not profiling.spans_enabled()


def test_traced_fmm_run_reports_the_fmm_spans():
    res = run.run_cell(FMM_CELLS[1], SEED, 0.1, True, device_type="cpu",
                       n=FMM_N)
    metrics = res["metrics"]
    for name in FMM_READERS:
        assert metrics[name]["value"] > 0, name
    # The phases lie inside the force call the harness times.
    inner = sum(metrics[k]["value"] for k in FMM_SPANS)
    assert 0 < inner <= metrics["force_call_ms"]["value"] * 1.05
    # The dense layout reads the capacity back once a call.
    assert metrics["fmm_reads_per_call"]["value"] == 1.0


@pytest.mark.parametrize("name", FMM_READERS)
def test_fmm_readers_without_fmm_spans_read_nothing(name):
    """A window whose snapshots hold no ``fmm.*`` span (the program before
    it had them, or another tier ran) leaves the metric out."""
    mod = catalog.reader("metrics", name)
    rec = run.RunRecord(name, {}, {}, {"tree": {"order": 8}}, 1, 4_000_000,
                        3, steps=2, force_calls=2)
    force = {"sim.force": (1.0, 2)}
    snap = {"all": force, "outside": force, "counters": {}}
    rec.snapshots[name] = [{"all": {}, "outside": {}, "counters": {}}, snap]
    assert mod.read(rec) is None
    rec.snapshots[name] = [None, None]
    assert mod.read(rec) is None


def _brute_pairs(dim, level):
    """V-list pairs of one level by enumeration: every target cell c and
    every offset δ of at most 4 cells a dimension (wider than any V-list),
    counted where c + δ lies inside the grid, outside c's near ring (some
    |δ_d| > 1) and inside its parent's near ring (the parents within 1 cell
    in every dimension)."""
    side = 1 << level
    cells = np.stack(np.meshgrid(*[np.arange(side)] * dim, indexing="ij"),
                     -1).reshape(-1, dim)
    pairs = 0
    for delta in itertools.product(range(-4, 5), repeat=dim):
        if max(abs(d) for d in delta) <= 1:
            continue
        src = cells + np.array(delta)
        ok = ((src >= 0) & (src < side)
              & (np.abs(src // 2 - cells // 2) <= 1)).all(axis=1)
        pairs += int(ok.sum())
    return pairs


@pytest.mark.parametrize("dim,level", [(2, 2), (2, 3), (2, 4), (3, 2),
                                       (3, 3), (3, 4)])
def test_v_list_pairs_match_enumeration(dim, level):
    assert fmm_work.v_list_pairs(dim, level) == _brute_pairs(dim, level)


def test_m2l_work_of_the_cells():
    """4e6 3D at order 8: leaf level 5, 6,039,504 pairs over levels 2-5,
    47.3 ms at 67e12/s; Plummer 1e5 3D: leaf level 3."""
    assert fmm_work.leaf_level(4_000_000, 3) == 5
    assert fmm_work.leaf_level(100_000, 3) == 3
    assert sum(fmm_work.v_list_pairs(3, l) for l in range(2, 6)) == 6_039_504
    assert math.isclose(fmm_work.m2l_least_s(4_000_000, 3, 8), 0.04726,
                        rel_tol=1e-3)
    # Below leaf level 2 there is no V-list.
    assert fmm_work.m2l_ops(2000, 3, 8) == 0
