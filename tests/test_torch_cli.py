"""nbody_tpu_torch CLI, harness and registry (CPU device)."""

import numpy as np
import pytest
import torch

from nbody_tpu.cli import main as jax_cli
from nbody_tpu_torch import cli
from nbody_tpu_torch.bench import registry
from nbody_tpu_torch.bench.harness import (Tee, format_time_s, get_run_id,
                                           run_benchmark, safely_execute)
from nbody_tpu_torch.state import random_system


def test_cli_accuracy_run_and_csv_header_match_jax(tmp_path, capsys):
    args = ["-d", "2", "-N", "64", "-a", "1", "-m", "a", "--warmup", "0"]
    assert jax_cli(args + ["--results-dir", str(tmp_path / "jax")]) == 0
    capsys.readouterr()
    rc = cli.main(args + ["--device", "cpu", "--results-dir",
                          str(tmp_path / "torch")])
    assert rc == 0
    assert "accuracy: 100.00%" in capsys.readouterr().out
    (jcsv,), (tcsv,) = ((tmp_path / d).glob("run_*_N_64_2D.csv")
                        for d in ("jax", "torch"))
    assert tcsv.read_text().splitlines()[0] == \
        jcsv.read_text().splitlines()[0]
    rows = tcsv.read_text().splitlines()[1:]
    assert [r.split(",")[0] for r in rows] == ["BruteForce_Torch"]


def test_cli_no_files_and_steps(capsys):
    rc = cli.main(["-d", "3", "-N", "32", "-m", "a", "--device", "cpu",
                   "--no-files", "--warmup", "0", "--steps", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Simulating 2 leapfrog steps" in out
    assert "final position of body 0:" in out


# Every tier is ported; the guard for a tier left out of PORTED_TIERS is
# exercised by taking h out again.
@pytest.mark.parametrize("tiers", ["bh", "ah", "h"])
def test_cli_unported_tier_exits_2(tiers, capsys, monkeypatch):
    monkeypatch.setattr(registry, "PORTED_TIERS", "abf")
    assert cli.main(["-m", tiers, "--device", "cpu", "--no-files"]) == 2
    assert "not ported" in capsys.readouterr().err
    monkeypatch.undo()
    assert cli.main(["-m", tiers, "--device", "cpu", "--dry-run"]) == 0
    assert "BVH_Radix" in capsys.readouterr().out


def test_cli_default_tiers_leave_out_unported(capsys, monkeypatch):
    assert cli.main(["--device", "cpu", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "left out" not in out and "BVH_Radix" in out
    monkeypatch.setattr(registry, "PORTED_TIERS", "abf")
    assert cli.main(["--device", "cpu", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "left out" in out and "BruteForce_Torch" in out
    assert "BVH_Radix" not in out


def test_cli_bad_tier_and_gate(capsys):
    assert cli.main(["-m", "xyz", "--no-files"]) == 2
    assert cli.main(["-N", "1000001", "--device", "cpu", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "skipping brute-force tier" in out
    assert "BarnesHut_Grid" in out and "BruteForce" not in out.split(
        "methods=")[1]


def test_cli_cuda_without_gpu_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-N", "16", "-m", "a", "--no-files"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_registry_gates_cuda_methods_on_the_run_device():
    assert [m.name for m in registry.methods_for_tiers("a", "cpu")] == \
        ["BruteForce_Torch"]
    names = {m.name for m in registry.methods_for_tiers("abhf", "cuda")}
    assert names == {"BruteForce_Torch", "BruteForce_CUDA", "BarnesHut_Grid",
                     "BarnesHut_Grid_Theta05", "BVH_Radix", "FMM_Chebyshev"}
    assert [m.name for m in registry.methods_for_tiers("b", "cpu")] == \
        ["BarnesHut_Grid", "BarnesHut_Grid_Theta05"]
    assert registry.get("BruteForce_CUDA").hyperparams(10, 2, None, None) \
        == {"kernel": "cuda_symmetric"}
    assert registry.reference_method_for(1 << 20, "cpu").name == \
        "BruteForce_Torch"
    assert registry.reference_method_for(1 << 20, "cuda").name == \
        "BruteForce_CUDA"
    assert registry.reference_method_for(1000, "cuda").name == \
        "BruteForce_Torch"


def test_harness_pieces(capsys):
    t, out = safely_execute(Tee(None), "Boom", lambda: 1 / 0, warmup=0)
    assert t == -1.0 and out is None
    assert "ZeroDivisionError" in capsys.readouterr().out
    assert format_time_s(1.5) == "1.500000" and "e-" in format_time_s(5e-8)
    import datetime
    assert get_run_id(datetime.datetime(2026, 8, 16, 4, 5, 6)) == \
        "08162026_040506"


def test_run_benchmark_records_failure(tmp_path):
    system = random_system(32, 2, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    bad = registry.Method("Bad", "a", lambda *a: 1 / 0)
    results = run_benchmark(system, [bad] + registry.methods_for_tiers(
        "a", "cpu"), compute_accuracy=True, run_id="t1",
        results_dir=str(tmp_path), warmup=0)
    assert [r.time_s < 0 for r in results] == [True, False]
    assert results[1].accuracy_pct == 100.0
    csv = (tmp_path / "run_t1_N_32_2D.csv").read_text().splitlines()
    assert csv[1].startswith("Bad,32,2,-1.000000")
    assert np.isfinite(results[1].norm_error)
