"""The port's sweep and analysis (nbody_tpu_torch.bench.sweep, .analysis)
on the CPU: the quick sweep's CSVs, the chunked --sizes/--accuracy/--run-id
form, and the aggregation and speedup tables against the JAX package's
nbody_tpu.bench.analysis on the same rows (exact: the same arithmetic)."""

import csv
import glob
import os

import pytest

from nbody_tpu.bench import analysis as janalysis
from nbody_tpu_torch.bench import analysis, sweep


def _rows(results_dir):
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir, "run_*.csv"))):
        with open(path) as f:
            out.extend(csv.DictReader(f))
    return out


def test_quick_sweep_tier_a_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "res")
    assert sweep.main(["--sizes", "1000", "--tiers", "a", "--device", "cpu",
                       "--results-dir", d, "--warmup", "0"]) == 0
    out = capsys.readouterr().out
    assert "sweep complete: 4 method-runs, 0 failed" in out
    rows = _rows(d)
    # 2D and 3D, accuracy off and on (1000 is a reference accuracy size).
    assert len(rows) == 4
    assert {r["Method"] for r in rows} == {"BruteForce_Torch"}
    assert sorted((r["Dimension"], r.get("Accuracy(%)") is not None)
                  for r in rows) == [("2", False), ("2", True), ("3", False),
                                     ("3", True)]
    assert all(float(r["Time(s)"]) >= 0 for r in rows)
    acc = [r for r in rows if r.get("Accuracy(%)") not in (None, "")]
    assert acc and all(float(r["Accuracy(%)"]) == 100.0 for r in acc)


def test_chunked_sweep_form(tmp_path):
    """--sizes with --accuracy off, then on, under one --run-id: one CSV per
    (config, accuracy) with the shared id; analysis aggregates them."""
    d = str(tmp_path / "res")
    common = ["--sizes", "1e3", "--dims", "2", "--tiers", "a", "--device",
              "cpu", "--results-dir", d, "--run-id", "chunked",
              "--warmup", "0"]
    assert sweep.main(common + ["--accuracy", "off"]) == 0
    assert sweep.main(common + ["--accuracy", "on"]) == 0
    files = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(d, "*.csv")))
    assert files == ["run_chunked_N_1000_2D.csv",
                     "run_chunked_N_1000_2D_1.csv"]
    assert analysis.main([d]) == 0
    agg = analysis.aggregate(analysis.load_results(d))
    assert agg[(1000, "BruteForce_Torch", 2)]["Runs"] == 2


def _write(path, rows, accuracy):
    with open(path, "w") as f:
        f.write("Method,Bodies,Dimension,Time(s)"
                + (",Accuracy(%),NormError" if accuracy else "")
                + ",Hyperparams\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")


@pytest.fixture
def results(tmp_path):
    d = tmp_path / "res"
    d.mkdir()
    _write(d / "run_a_N_1000_2D.csv",
           [("BruteForce_Torch", 1000, 2, 0.5, ""),
            ("BarnesHut_Grid", 1000, 2, 0.125, ""),
            ("FMM_Chebyshev", 1000, 2, -1.0, "")], False)
    _write(d / "run_b_N_1000_2D.csv",
           [("BruteForce_Torch", 1000, 2, 0.25, "100.00", "1e-9", ""),
            ("BarnesHut_Grid", 1000, 2, 0.0625, "99.50", "3e-4", ""),
            ("BVH_Radix", 1000, 3, 2.0, "98.00", "1e-3", "")], True)
    return str(d)


def test_failed_rows_are_excluded(results):
    rows = analysis.load_results(results)
    assert len(rows) == 5
    assert all(r["Time(s)"] >= 0 for r in rows)
    assert "FMM_Chebyshev" not in {r["Method"] for r in rows}


def test_aggregate_and_speedups_equal_the_jax_package(results):
    rows = analysis.load_results(results)
    assert rows == janalysis.load_results(results)
    agg = analysis.aggregate(rows)
    assert agg == janalysis.aggregate(rows)
    assert agg[(1000, "BarnesHut_Grid", 2)]["Time(s)"] == 0.09375
    sp = analysis.speedup_table(agg)
    assert sp == janalysis.speedup_table(agg, "BruteForce_Torch")
    assert sp == [{"Bodies": 1000, "Dimension": 2, "Method": "BarnesHut_Grid",
                   "Speedup": 4.0}]
    out = os.path.join(results, "agg.csv")
    analysis.write_aggregated(agg, out)
    jout = os.path.join(results, "jagg.csv")
    janalysis.write_aggregated(agg, jout)
    assert open(out).read() == open(jout).read()


def test_analysis_main_aggregates_every_row(results, capsys):
    assert analysis.main([results]) == 0
    assert "aggregated 5 rows into 3 groups" in capsys.readouterr().out
    assert analysis.load_reference_best(None) == {}
    assert analysis.main([os.path.join(results, "empty")]) == 1
