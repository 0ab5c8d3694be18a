"""The Plummer FMM cell (``plummer3d_1e5_fmm.fmm_leapfrog``) on the FMM's
occupied-cell layout: its entry in ``BENCHMARK.json``, a traced CPU run at
a small N, the readers of the layout's counters (``fmm_occupied_cells``,
``near_roofline``, ``m2l_occupied_roofline``), and
``benchmark/clustered_work.py``'s count of the near pairs against a brute
enumeration and against the program's counter."""

import math

import pytest

from benchmark import catalog, clustered_work, inputs, roofline, run

from conftest import SEED

CELL = "plummer3d_1e5_fmm.fmm_leapfrog"
FMM_N = 3000
FMM_SPANS = ["fmm_build_ms", "fmm_upward_ms", "fmm_m2l_ms",
             "fmm_downward_ms", "fmm_p2p_ms"]
OCCUPIED_READERS = ["fmm_occupied_cells", "near_roofline",
                    "m2l_occupied_roofline"]


@pytest.fixture(autouse=True)
def spans_off():
    from nbody_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_plummer_fmm_cell_is_declared():
    """The cell is in ``BENCHMARK.json`` on one card, its files agree with
    its entry and hold ``force_err`` to the deployment's 1e-4; the phase
    spans and ``fmm_reads_per_call`` read it beside the 4e6 cell,
    ``m2l_roofline`` (the dense grid's V-list count) does not, and the
    occupied-cell layout's readers read it alone."""
    bench = catalog.spec()
    entry, = [w for w in bench["workloads"] if w["name"] == CELL]
    cell, config, mix = catalog.cell(CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        config["name"], mix["name"], 1)
    assert (mix["method"], mix["forces"]) == ("fmm", "simulation")
    assert cell["check"]["limits"]["force_err"] <= 1e-4
    workloads = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    for name in FMM_SPANS + ["fmm_reads_per_call"]:
        assert CELL in workloads[name], name
    assert CELL not in workloads["m2l_roofline"]
    for name in OCCUPIED_READERS:
        assert workloads[name] == [CELL], name


def test_traced_plummer_run_reads_the_occupied_layout():
    """The cell's traced CPU run takes the occupied-cell layout: its
    counters' readers read, the phase spans lie inside the force call, and
    the read-backs are the capacity probe, the depth probe and, on the
    CPU, the plain near field's size."""
    res = run.run_cell(CELL, SEED, 0.1, True, device_type="cpu", n=FMM_N)
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    for name in FMM_SPANS + OCCUPIED_READERS:
        assert metrics[name]["value"] > 0, name
    assert "m2l_roofline" not in metrics
    inner = sum(metrics[k]["value"] for k in FMM_SPANS)
    assert 0 < inner <= metrics["force_call_ms"]["value"] * 1.05
    assert metrics["fmm_reads_per_call"]["value"] == 3.0


def _record(name, end_counters):
    rec = run.RunRecord(name, {}, {}, {"tree": {"order": 8}}, 1, 100_000,
                        3, steps=2, force_calls=2)
    spans_ = {"sim.force": (1.0, 2), "fmm.p2p": (0.5, 2),
              "fmm.m2l": (0.25, 2), "fmm.build": (0.1, 2)}
    end = {"all": spans_, "outside": spans_, "counters": end_counters}
    rec.snapshots[name] = [{"all": {}, "outside": {}, "counters": {}}, end]
    return rec


@pytest.mark.parametrize("name", OCCUPIED_READERS)
def test_occupied_readers_without_the_counter_read_nothing(name):
    """A window in which the ``fmm.*`` spans ran but no occupied-cell tree
    was built (the program before that layout, or the dense layout) leaves
    the metric out."""
    mod = catalog.reader("metrics", name)
    assert mod.read(_record(name, {"fmm.reads": 4})) is None


def test_occupied_rooflines_read_the_counted_pairs():
    """Two calls of 0.25 s of ``fmm.p2p`` and 0.125 s of ``fmm.m2l``
    each: the shares are the counted pairs a call at their operations and
    67e12 a second over those times."""
    counters = {"fmm.near_pairs": 2 * 10 ** 9, "fmm.m2l_pairs": 2 * 10 ** 7}
    near = catalog.reader("metrics", "near_roofline").read(
        _record("near_roofline", counters))
    m2l = catalog.reader("metrics", "m2l_occupied_roofline").read(
        _record("m2l_occupied_roofline", counters))
    assert math.isclose(near, 100 * 1e9 * 21 / 67e12 / 0.25)
    assert math.isclose(m2l, 100 * 1e7 * 2 * 512 ** 2 / 67e12 / 0.125)


def _brute_near_pairs(pos, level):
    """The near pairs by enumeration: every ordered pair of bodies (each
    body with itself too) whose cells at ``level`` lie within one cell of
    each other in every dimension."""
    c = clustered_work._cells(pos, level)
    return int(((c[:, None, :] - c[None, :, :]).abs().amax(-1) <= 1).sum())


@pytest.mark.parametrize("dim,level", [(3, 3), (3, 5), (2, 6)])
def test_clustered_work_counts_the_near_pairs(dim, level):
    _, config, _ = catalog.cell(CELL)
    config = dict(config, dim=dim)
    pos = inputs.make_bodies(config, SEED, "cpu", n=1500)[0]
    assert clustered_work.near_pairs(pos, level) == _brute_near_pairs(pos,
                                                                      level)


def test_clustered_work_depth_rule_and_pair_ops():
    """The frozen depth rule is the port's on the same bodies, at the
    cell's softening too, and the one-sided pair keeps K2's 16 operations
    in 2D."""
    from nbody_tpu_torch.ops import sparse_grid
    _, config, _ = catalog.cell(CELL)
    pos = inputs.make_bodies(config, SEED, "cpu", n=20_000)[0]
    level = clustered_work.leaf_level(pos)
    assert level == sparse_grid.occupied_levels(pos)[0] == \
        sparse_grid.occupied_levels(pos, softening=config["softening"])[0]
    assert int(clustered_work._occupancy(pos, level)[1].max()) <= 256
    assert clustered_work.pair_ops(2) == roofline.ONE_SIDED_PAIR_OPS[2]
    assert clustered_work.pair_ops(3) == 21
    assert clustered_work.m2l_pair_ops(3, 8) == 2 * 512 ** 2


def test_program_counts_the_near_pairs_of_its_tree():
    """The program's counter ``fmm.near_pairs`` on one force call equals
    the near pairs counted from the same bodies at the same leaf level."""
    import torch
    from nbody_tpu_torch.config import GravityConfig
    from nbody_tpu_torch.ops import fmm
    from nbody_tpu_torch.utils import profiling
    _, config, _ = catalog.cell(CELL)
    pos, _, mass = inputs.make_bodies(config, SEED, "cpu", n=FMM_N)
    pos, mass = pos.to(torch.float64), mass.to(torch.float64)
    cfg = GravityConfig(G=1.0, softening=config["softening"])
    profiling.enable_spans()
    fmm.fmm_forces(pos, mass, cfg, order=3, layout="adaptive")
    got = profiling.counter_totals()["fmm.near_pairs"]
    assert got == clustered_work.near_pairs(pos)
