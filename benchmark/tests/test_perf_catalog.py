"""A later change adds a configuration, a mix, a cell and a metric as new
files and ``BENCHMARK.json`` entries, and edits no file: the harness finds
each by name. Shown on a copy of the benchmark's folder with made-up parts."""

import json
import re
import shutil

import pytest

from benchmark import catalog, run

from conftest import SEED

MADE_CONFIG = {
    "name": "made_2d", "source": "made up for this test",
    "n": 500, "dim": 2, "dtype": "float32",
    "bodies": {"kind": "uniform", "position_range": [0.0, 1.0],
               "velocity_range": [-0.1, 0.1], "mass_range": [0.5, 1.5]},
    "G": 1.0, "softening": 0.05, "dt": 0.001, "reduced": [], "assumed": {}}
MADE_MIX = {"name": "made_mix", "method": "brute",
            "integrator": "leapfrog", "forces": "simulation",
            "warmup_steps": 2}
MADE_CELL = {"name": "made_2d.made_mix", "config": "made_2d",
             "mix": "made_mix", "chips": 1,
             "check": {"rows": 64, "limits": {"force_err": 1e-4,
                                              "pos_err": 1e3,
                                              "vel_err": 1.0}}}
MADE_METRIC = '''"""A made-up per-layer metric: force calls times ten."""


def read(run):
    return 10.0 * run.force_calls
'''


@pytest.fixture
def made_up(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    for kind in ("configs", "mixes", "workloads", "metrics", "end_to_end"):
        shutil.copytree(catalog.HERE / kind, here / kind)
    for kind, name, body in (("configs", "made_2d", MADE_CONFIG),
                             ("mixes", "made_mix", MADE_MIX),
                             ("workloads", "made_2d.made_mix", MADE_CELL)):
        (here / kind / f"{name}.json").write_text(json.dumps(body))
    (here / "metrics" / "made.metric-1.py").write_text(MADE_METRIC)
    bench = catalog.spec()
    bench["configs"].append({"name": "made_2d", "source": "made up",
                             "file": "benchmark/configs/made_2d.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "made_2d.made_mix",
                               "config": "made_2d", "traffic": "made_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "made.metric-1", "unit": "calls",
                               "better": "lower", "source": "program_counter",
                               "layer": "simulation / integrators",
                               "moves": "step_ms",
                               "workloads": ["made_2d.made_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(catalog, "HERE", here)
    monkeypatch.setattr(catalog, "ROOT", tmp_path)
    return tmp_path


def test_made_up_parts_are_found_by_name(made_up):
    cell, config, mix = catalog.cell("made_2d.made_mix")
    assert (config["n"], mix["warmup_steps"]) == (500, 2)
    res = run.run_cell("made_2d.made_mix", SEED, 0.2, True,
                       device_type="cpu")
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert metrics["made.metric-1"]["unit"] == "calls"
    # Two force calls a leapfrog step, ten times: 20 a step of the window.
    assert metrics["made.metric-1"]["value"] == 20.0 * (res["attempted"] - 2)
    # Metrics that list only other cells are not read here.
    assert set(metrics) == {"made.metric-1"}


def test_untraced_run_reports_the_end_to_end_metrics(made_up):
    res = run.run_cell("made_2d.made_mix", SEED, 0.2, False,
                       device_type="cpu")
    assert set(res["metrics"]) == {"setup_s", "step_ms"}
    assert res["metrics"]["step_ms"]["value"] > 0


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        catalog.cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        catalog.reader("metrics", "no_such_metric")


def test_benchmark_json_names_the_cell_files():
    bench = catalog.spec()
    for w in bench["workloads"]:
        cell, config, mix = catalog.cell(w["name"])
        assert (cell["config"], cell["mix"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
    for c in bench["configs"]:
        assert catalog.load("configs", c["name"])["reduced"] == c["reduced"]
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            kind = "end_to_end" if section == "end_to_end" else "metrics"
            assert hasattr(catalog.reader(kind, m["name"]), "read")


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    raw = (catalog.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    bench = json.loads(raw)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and NAME.match(c["name"])
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for cell in cells:
        assert catalog.metrics_of(cell, "per_layer", bench)
        assert len(catalog.metrics_of(cell, "end_to_end", bench)) >= 2
