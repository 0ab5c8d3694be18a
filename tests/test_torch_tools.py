"""The port's tools and examples (nbody_tpu_torch.tools, .examples) on the
CPU: the pure-Python tools against the JAX repo's copies in ``tools/``,
the method smoke's budget map, the mesh's collective census, simulate_1m
against the JAX tool's loop, the multichip tool on CPU meshes.

Tolerances: simulate_1m's final fp32 state 1e-5 of the largest value
(each side rounds its own BVH sums, three carried leapfrog steps);
everything else exact (the same arithmetic, or counts).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import prune_superseded as jprune  # noqa: E402  (the JAX repo's tool)
from nbody_tpu.config import GravityConfig as JGravity  # noqa: E402
from nbody_tpu.integrators import leapfrog_step_carried  # noqa: E402
from nbody_tpu.ops.brute_force import brute_force_blocked  # noqa: E402
from nbody_tpu.ops.bvh import bvh_forces as jbvh_forces  # noqa: E402
from nbody_tpu.ops.grid_tree import barnes_hut_grid as jbh  # noqa: E402
from nbody_tpu.state import System as JSystem  # noqa: E402
from nbody_tpu.utils.accuracy import scale_normalized_error  # noqa: E402
from nbody_tpu_torch.bench.registry import all_methods  # noqa: E402
from nbody_tpu_torch.examples import galaxy_demo, multichip_ring  # noqa: E402
from nbody_tpu_torch.parallel import make_mesh, ring_brute_force  # noqa: E402
from nbody_tpu_torch.state import random_system, system_from_numpy  # noqa
from nbody_tpu_torch.tools import (compare_vs_baseline,  # noqa: E402
                                   method_smoke, multichip_scaling,
                                   prune_superseded, run_full_sweep,
                                   simulate_1m)

torch.set_num_threads(2)


# --- prune_superseded --------------------------------------------------------

def _write_run(d, name, rows):
    with open(os.path.join(d, name), "w") as f:
        f.write("Method,Bodies,Dimension,Time(s)\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")


@pytest.fixture
def run_files(tmp_path):
    d = str(tmp_path)
    _write_run(d, "run_r2fp1_BVH_Radix_N_1000_2D.csv",
               [("BVH_Radix", 1000, 2, 0.5)])
    _write_run(d, "run_r4fp1_BVH_Radix_N_1000_2D.csv",
               [("BVH_Radix", 1000, 2, 0.2)])
    open(os.path.join(d, "run_r3fp1_BVH_Radix_N_2000_2D.csv"), "w").close()
    _write_run(d, "run_r2fp1_FMM_Chebyshev_N_1000_2D.csv",
               [("FMM_Chebyshev", 1000, 2, 0.1)])
    _write_run(d, "run_r2fp1_BarnesHut_Grid_N_1000_3D.csv",
               [("BarnesHut_Grid", 1000, 3, 0.3)])
    _write_run(d, "run_r4fp1_BarnesHut_Grid_N_1000_3D.csv",
               [("BarnesHut_Grid", 1000, 3, -1.0)])
    _write_run(d, "run_r2ap1_BVH_Radix_N_1000_2D.csv",
               [("BVH_Radix", 1000, 2, 0.6)])
    _write_run(d, "run_r5fp1_BruteForce_CUDA_N_1000_3D.csv",
               [("BruteForce_CUDA", 1000, 3, 0.01)])
    _write_run(d, "run_r1fp1_BruteForce_CUDA_N_1000_3D.csv",
               [("BruteForce_CUDA", 1000, 3, 0.02)])
    return d


def test_prune_plan_equals_the_jax_tools(run_files):
    have = prune_superseded.plan(run_files)
    assert have == jprune.plan(run_files)
    assert {os.path.basename(p): why for p, why in have} == {
        "run_r2fp1_BVH_Radix_N_1000_2D.csv": "superseded by r4",
        "run_r3fp1_BVH_Radix_N_2000_2D.csv": "no valid rows",
        "run_r4fp1_BarnesHut_Grid_N_1000_3D.csv": "no valid rows",
        "run_r1fp1_BruteForce_CUDA_N_1000_3D.csv": "superseded by r5",
    }


def test_prune_main_moves_the_files(run_files):
    retired = {os.path.basename(p) for p, _ in jprune.plan(run_files)}
    assert prune_superseded.main(["--results-dir", run_files]) == 0
    assert set(os.listdir(os.path.join(run_files, "superseded"))) == retired
    assert prune_superseded.plan(run_files) == []


# --- run_full_sweep ----------------------------------------------------------

def test_sweep_matrix_and_resume_rows(tmp_path):
    chunks = run_full_sweep.chunks_for(run_full_sweep.SIZES, (2, 3),
                                       run_full_sweep.METHODS)
    # 8 sizes x 2 dims x 6 methods, less the brute rows above the gate
    # (BruteForce_Torch at 2e6 and 5e6), plus 4 accuracy sizes x 2 x 6.
    assert len(chunks) == 8 * 2 * 6 - 2 * 2 + 4 * 2 * 6
    assert (5_000_000, 3, False, "BruteForce_CUDA") in chunks
    assert (5_000_000, 3, False, "BruteForce_Torch") not in chunks
    d = tmp_path
    (d / "run_x_N_1000_2D.csv").write_text(
        "Method,Bodies,Dimension,Time(s),Accuracy(%)\n"
        "BVH_Radix,1000,2,0.5,\nFMM_Chebyshev,1000,2,-1,\n"
        "BVH_Radix,1000,2,0.4,99.9\n")
    (d / "aggregated_results.csv").write_text(
        "Method,Bodies,Dimension,Time(s)\nBarnesHut_Grid,1000,2,0.1\n")
    assert run_full_sweep.completed_rows(str(d)) == {
        ("BVH_Radix", 1000, 2, False), ("BVH_Radix", 1000, 2, True)}


def test_sweep_main_runs_each_chunk_once_and_resumes(tmp_path, monkeypatch,
                                                    capsys):
    """One pass: a failed chunk is not retried in the same run, a second
    run takes only what is missing, and the files carry the pattern
    ``prune_superseded`` reads."""
    calls = []

    def fake_run(cmd, timeout):
        arg = dict(zip(cmd[3::2], cmd[4::2]))
        calls.append(arg["--run-id"])
        ok = arg["--accuracy"] == "off" or len(calls) > 2
        path = os.path.join(arg["--results-dir"], f"run_{arg['--run-id']}"
                            f"_N_{arg['--sizes']}_{arg['--dims']}D.csv")
        with open(path, "w") as f:
            acc = "" if arg["--accuracy"] == "off" else "99"
            f.write("Method,Bodies,Dimension,Time(s),Accuracy(%)\n"
                    f"{arg['--methods']},{arg['--sizes']},{arg['--dims']},"
                    f"{0.1 if ok else -1},{acc}\n")
        return subprocess.CompletedProcess(cmd, 0 if ok else 1)

    monkeypatch.setattr(run_full_sweep.subprocess, "run", fake_run)
    argv = ["--results-dir", str(tmp_path), "--sizes", "1e3", "--dims", "2",
            "--methods", "BVH_Radix", "--device", "cpu"]
    assert run_full_sweep.main(argv) == 0
    assert calls == ["r1fp1_BVH_Radix", "r1ap1_BVH_Radix"]
    assert "1 chunks still missing" in capsys.readouterr().out
    assert all(prune_superseded.NAME_RE.match(name)
               for name in os.listdir(tmp_path))
    assert run_full_sweep.main(argv) == 0
    assert calls[2:] == ["r1ap1_BVH_Radix"]
    assert run_full_sweep.main(argv) == 0
    assert len(calls) == 3


# --- compare_vs_baseline -----------------------------------------------------

def test_compare_scores_wins_losses_and_device_steps(tmp_path, capsys):
    ours = tmp_path / "agg.csv"
    ours.write_text(
        "Bodies,Method,Dimension,Time(s),Accuracy(%),Runs\n"
        "1000,BruteForce_CUDA,2,0.5,,1\n"       # dev-step 1e-4: a win
        "1000000,BarnesHut_Grid,2,0.2,,1\n"     # 8.09 / 0.2: a win
        "1000000,BVH_Radix,2,20.0,,1\n"         # 9.72 / 20: a loss
        "1000,BarnesHut_Grid,2,0.03,,1\n"       # eager row unscored: a loss
        "5000000,FMM_Chebyshev,3,1.0,,1\n")     # no reference row
    ref = tmp_path / "ref.csv"
    ref.write_text(
        "Bodies,Method,Dimension,Average Runtime (s)\n"
        "1000,BruteForce_CUDA,2,0.000449\n1000,BruteForce_Parlay,2,0.01\n"
        "1000000,BarnesHut_Parlay,2,8.09\n1000000,BVH_Parlay,2,9.72\n"
        "1000000,BVH_Sequential,2,-1\n1000,BarnesHut_Parlay,2,0.02\n")
    steps = tmp_path / "steps.csv"
    steps.write_text("Bodies,Method,Dimension,StepTime(s),Steps,Dispatch\n"
                     "1000,BruteForce_CUDA,2,1.0e-04,448,graph\n"
                     "1000000,BarnesHut_Grid,2,1.0e-04,448,eager\n"
                     "1000,BarnesHut_Grid,2,1.0e-05,64,eager\n")
    rc = compare_vs_baseline.main(["--ours", str(ours), "--ref", str(ref),
                                   "--device-steps", str(steps)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "5 cells: 2 wins, 2 losses, 1 uncontested" in out
    assert "1 cells scored on the per-step device time" in out
    assert "N=1000000 2D BVH_Radix: 20.000s vs BVH_Parlay 9.720s" in out
    assert "N=1000 2D BarnesHut_Grid: 0.030s vs BarnesHut_Parlay" in out
    assert compare_vs_baseline.main(["--ours", str(ours), "--ref",
                                     str(tmp_path / "none.csv")]) == 2


def test_compare_scores_the_jax_tools_device_steps(tmp_path, capsys):
    """A JAX-schema row (no ``Dispatch``: one ``lax.scan``) is scored."""
    ours = tmp_path / "agg.csv"
    ours.write_text("Bodies,Method,Dimension,Time(s),Accuracy(%),Runs\n"
                    "1000,BarnesHut_Grid,3,0.5,,1\n")
    ref = tmp_path / "ref.csv"
    ref.write_text("Bodies,Method,Dimension,Average Runtime (s)\n"
                   "1000,BarnesHut_Parlay,3,0.01\n")
    steps = tmp_path / "steps.csv"
    steps.write_text("Bodies,Method,Dimension,StepTime(s),Steps\n"
                     "1000,BarnesHut_Grid,3,2.0e-04,512\n")
    assert compare_vs_baseline.main(["--ours", str(ours), "--ref", str(ref),
                                     "--device-steps", str(steps)]) == 0
    out = capsys.readouterr().out
    assert "1 cells: 1 wins, 0 losses, 0 uncontested" in out
    assert "1 cells scored on the per-step device time" in out


# --- method_smoke ------------------------------------------------------------

def test_every_registered_method_has_a_budget():
    for name in all_methods():
        for dim in (2, 3):
            for clustered in (False, True):
                assert method_smoke.budget_for(name, dim, clustered) > 0
    # The prefix trap: the oracle's own blocking keeps the JAX twin's 1e-7.
    assert method_smoke.budget_for("BruteForce_Torch", 2) == 1e-7
    assert method_smoke.budget_for("BruteForce_CUDA", 3) == 7e-5
    assert method_smoke.budget_for("BarnesHut_Grid_Theta05", 3) == 1e-2
    assert method_smoke.budget_for("BarnesHut_Grid+point", 3) == 2.5e-4
    assert method_smoke.budget_for("BVH_Radix+local", 2, True) == 5e-4
    with pytest.raises(KeyError):
        method_smoke.budget_for("BarnesHut_Octree", 2)


def test_theta05_2d_budget_is_three_times_the_reference_reading():
    """The one budget set on the port's draw: the JAX package's own
    θ = 0.5 error on the tool's bodies (N = 20,000 2D), times ~3."""
    s = random_system(20_000, 2, generator=torch.Generator().manual_seed(
        method_smoke.SEED), device="cpu")
    p, m = jnp.asarray(s.positions.numpy()), jnp.asarray(s.masses.numpy())
    cfg = JGravity()
    reading = float(scale_normalized_error(
        jbh(p, m, cfg, theta=0.5), brute_force_blocked(p, m, cfg,
                                                       block_size=1024)))
    budget = method_smoke.budget_for("BarnesHut_Grid_Theta05", 2)
    assert 2.5 * reading <= budget <= 4 * reading, (reading, budget)


def test_method_smoke_runs_every_method_on_the_cpu(capsys):
    assert method_smoke.main(["-N", "600", "--dim", "3", "--device",
                              "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("BruteForce_Torch", "BarnesHut_Grid", "BVH_Radix",
                 "FMM_Chebyshev"):
        assert f"  {name} " in out
    assert "all methods within budget" in out


# --- the mesh's collective census --------------------------------------------

def _ring_bodies(n=256):
    rng = np.random.default_rng(9)
    return (torch.from_numpy(rng.uniform(0, 1, (n, 3))),
            torch.from_numpy(rng.uniform(0.5, 1, n)))


@pytest.mark.parametrize("p", [2, 3, 4])
def test_census_counts_the_one_sided_ring(p):
    mesh = make_mesh([torch.device("cpu")] * p)
    pos, mass = _ring_bodies()
    with mesh.census() as census:
        ring_brute_force(pos, mass, mesh=mesh, symmetric=False)
    rows = -(-256 // p)
    assert census == {"rotate": {
        "count": p - 1,
        "out_bytes": (p - 1) * p * rows * (3 + 1) * 8}}


def test_census_is_off_outside_its_block():
    mesh = make_mesh([torch.device("cpu")] * 4)
    pos, mass = _ring_bodies()
    with mesh.census() as census:
        pass
    ring_brute_force(pos, mass, mesh=mesh)
    assert census == {} and mesh.census_record is None
    with mesh.census() as outer:
        mesh.psum([torch.ones(3)] * 4)
        with mesh.census() as inner:
            ring_brute_force(pos, mass, mesh=mesh)
        mesh.all_gather([torch.ones(2)] * 4)
    assert outer == {"psum": {"count": 1, "out_bytes": 4 * 3 * 4},
                     "all_gather": {"count": 1, "out_bytes": 4 * 8 * 4}}
    # Two forward hops of (positions, masses), two return hops of shares:
    # 4 shards of 64 rows in f64.
    assert inner == {"rotate": {"count": 4, "out_bytes":
                                2 * 4 * 64 * (3 + 1) * 8
                                + 2 * 4 * 64 * 3 * 8}}


def test_ppermute_moves_a_tuple_a_shard_as_one_call():
    mesh = make_mesh([torch.device("cpu")] * 3)
    xs = [(torch.full((2,), float(r)), torch.full((3,), 10.0 + r))
          for r in range(3)]
    with mesh.census() as census:
        out = mesh.ppermute(xs, [(0, 1), (1, 2)])
    assert [tuple(t.tolist() for t in o) for o in out] == [
        ([0.0, 0.0], [0.0, 0.0, 0.0]), ([0.0, 0.0], [10.0] * 3),
        ([1.0, 1.0], [11.0] * 3)]
    assert census == {"ppermute": {"count": 1, "out_bytes": 3 * 5 * 4}}


def test_multichip_tool_on_cpu_meshes(tmp_path, capsys):
    out = str(tmp_path / "m.json")
    assert multichip_scaling.main(["--n", "1024", "--mesh-sizes", "2,3,4",
                                   "--cpu", "--out", out]) == 0
    with open(out) as f:
        tiers = json.load(f)["tiers"]
    assert set(tiers) == set(multichip_scaling.TIERS)
    for tier in multichip_scaling.TIERS:
        for p in ("2", "4"):
            assert tiers[tier][p]["err_vs_direct"] < \
                multichip_scaling.TIERS[tier]
    for tier in ("sharded_fmm", "sharded_barnes_hut", "let_barnes_hut",
                 "let_fmm", "let_bvh"):
        assert "refused" in tiers[tier]["3"]
    assert tiers["sharded_bvh"]["3"]["err_vs_direct"] < 3e-3
    for p in (2, 3, 4):
        assert tiers["ring_one_sided"][str(p)]["collectives"]["rotate"][
            "count"] == p - 1
    assert multichip_scaling.main(["--n", "1024", "--mesh-sizes", "2",
                                   "--out", str(tmp_path / "card.json")]) \
        == (0 if torch.cuda.is_available() else 2)


# --- simulate_1m -------------------------------------------------------------

def _plummer(n, dim, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-4, 1 - 1e-4, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    d = rng.normal(size=(n, dim))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = (r[:, None] * d).astype(np.float32)
    return pos, np.zeros_like(pos), np.full(n, 1.0 / n, np.float32)


def test_simulate_1m_matches_the_jax_tools_loop():
    pos, vel, mass = _plummer(512, 3, seed=4)
    steps, dt, theta = 3, 0.01, 0.5
    have, rec = simulate_1m.run(system_from_numpy(pos, vel, mass, "cpu"),
                                simulate_1m.CONFIG, "bvh", steps, dt, theta,
                                log=lambda *a: None)
    # The JAX tool's loop (tools/simulate_1m.py:69-99) on the same bodies.
    jcfg = JGravity(G=1.0, softening=0.05)
    caps = {}

    def forces(p, m):
        return jbvh_forces(p, m, jcfg, theta=theta, caps_state=caps)

    s = JSystem(positions=jnp.asarray(pos), velocities=jnp.asarray(vel),
                masses=jnp.asarray(mass))
    acc = forces(s.positions, s.masses) / s.masses[:, None]
    for _ in range(steps):
        s, acc = leapfrog_step_carried(s, acc, forces, dt)
    for h, w in ((have.positions, s.positions),
                 (have.velocities, s.velocities)):
        w = np.asarray(w)
        np.testing.assert_allclose(h.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert np.isfinite(rec["relative_energy_drift"])
    assert 0 < rec["relative_energy_drift"] < 1e-3
    assert len(rec["step_wall_s"]) == steps


def test_simulate_1m_main_writes_its_record(tmp_path, capsys):
    out = str(tmp_path / "s.json")
    assert simulate_1m.main(["--n", "300", "--steps", "2", "--method",
                             "bh-grid", "--dist", "uniform", "--dim", "2",
                             "--device", "cpu", "--out", out]) == 0
    with open(out) as f:
        rec = json.load(f)
    assert rec["backend"] == "cpu" and rec["device"] == "cpu"
    assert rec["force_method"] == "BarnesHut_Grid(quad)"
    assert np.isfinite(rec["relative_energy_drift"])


# --- examples ----------------------------------------------------------------

def test_examples_run_on_the_cpu(tmp_path, capsys):
    assert multichip_ring.main(["--cpu", "2", "--n", "256"]) == 0
    assert "ring forces over 2 shards" in capsys.readouterr().out
    assert galaxy_demo.main(["--n", "300", "--steps", "2", "--method",
                             "brute", "--device", "cpu", "--out",
                             str(tmp_path / "g.png")]) == 0
    assert "drift" in capsys.readouterr().out
