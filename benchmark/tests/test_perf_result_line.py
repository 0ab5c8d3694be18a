"""The result's keys, and the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import catalog, run

from conftest import CELLS, SEED, SMALL_N

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    res = run.run_cell(CELLS[2], SEED, 0.1, trace, device_type="cpu",
                       n=SMALL_N)
    want = CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    assert json.loads(json.dumps(res)) == res
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[2],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=env or dict(os.environ))


def test_no_card_no_result(cuda_absent):
    out = _cli(catalog.ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_port_no_result(tmp_path):
    shutil.copytree(catalog.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def cuda_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs none")
