"""Each cell at a small N on the CPU, through ``Simulation.run`` of the
port: the window drives it, and the sound run reads correct."""

import pytest

from benchmark import run

from conftest import CELLS, SEED, SMALL_N


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_through_simulation_run(cell, monkeypatch):
    from nbody_tpu_torch.simulation import Simulation
    calls = []
    original = Simulation.run

    def counted(self, steps, dt):
        calls.append(steps)
        return original(self, steps=steps, dt=dt)

    monkeypatch.setattr(Simulation, "run", counted)
    res = run.run_cell(cell, SEED, 0.2, False, device_type="cpu", n=SMALL_N)
    assert calls and set(calls) == {1}
    assert len(calls) == res["attempted"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["metrics"]["step_ms"]["value"] > 0


def test_seed_decides_the_bodies():
    from benchmark import catalog, inputs
    _, config, _ = catalog.cell(CELLS[0])
    a = inputs.make_bodies(config, SEED, "cpu", n=100)
    b = inputs.make_bodies(config, SEED, "cpu", n=100)
    c = inputs.make_bodies(config, SEED + 1, "cpu", n=100)
    assert all(x.equal(y) for x, y in zip(a, b))
    assert not a[0].equal(c[0])
    # A fixed set: every seed hands over the same bodies in another order.
    _, plummer, _ = catalog.cell("plummer3d_1e5.bvh_leapfrog")
    p = inputs.make_bodies(plummer, SEED, "cpu", n=100)
    q = inputs.make_bodies(plummer, SEED + 1, "cpu", n=100)
    assert not p[0].equal(q[0])
    assert p[0].sum(0).allclose(q[0].sum(0))
    assert sorted(p[0][:, 0].tolist()) == sorted(q[0][:, 0].tolist())
    rows = inputs.sample_rows(10_000, 64, SEED)
    assert rows.equal(inputs.sample_rows(10_000, 64, SEED))
    assert rows.unique().numel() == 64
