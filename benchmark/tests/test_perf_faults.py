"""A run with the timed path broken underneath reads ``correct`` false, for
each fault a cell can have (the look for a card skipped: CPU, small N).

* a step that returns its state unchanged (its forces still computed, or
  none);
* half of the bodies left out, the rest counted double as sources (their
  mean);
* the exchange between cards left out (the ring: every shard keeps its own
  block);
* one answer altered where it is produced (one body's force, by a tenth
  of the RMS force).
"""

import dataclasses

import pytest
import torch

from benchmark import run

from conftest import CELLS, SEED, SMALL_N


def _run(cell):
    return run.run_cell(cell, SEED, 0.2, False, device_type="cpu", n=SMALL_N)


def _wrap_forces(monkeypatch, cell, wrap):
    """Wrap whatever force function the cell's simulation gets."""
    original = run.build_simulation

    def build(config, mix, bodies, devices):
        sim, mesh = original(config, mix, bodies, devices)
        return dataclasses.replace(sim, forces_fn=wrap(sim.forces_fn)), mesh

    monkeypatch.setattr(run, "build_simulation", build)


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(cell, monkeypatch):
    from nbody_tpu_torch import simulation

    def unchanged(system, forces_fn, dt):
        forces_fn(system.positions, system.masses)
        forces_fn(system.positions, system.masses)
        return system

    monkeypatch.setattr(simulation, "leapfrog_step", unchanged)
    res = _run(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["pos_err"]["value"] > res["checks"]["pos_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_step_skipped(cell, monkeypatch):
    from nbody_tpu_torch.simulation import Simulation
    monkeypatch.setattr(Simulation, "run", lambda self, steps, dt:
                        dataclasses.replace(self,
                                            step_count=self.step_count + 1))
    res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_sources(cell, monkeypatch):
    def wrap(fn):
        def half(positions, masses):
            # Odd bodies left out as sources and targets; the even ones
            # count double as sources (the mean over the rest) and keep
            # their own mass as targets.
            keep = torch.zeros_like(masses)
            keep[::2] = 2.0
            return fn(positions, masses * keep) / keep.clamp(min=1)[:, None]
        return half
    _wrap_forces(monkeypatch, cell, wrap)
    res = _run(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["force_err"]["value"] > \
        res["checks"]["force_err"]["limit"]


def test_exchange_left_out(monkeypatch):
    from nbody_tpu_torch.utils.device_mesh import Mesh
    monkeypatch.setattr(Mesh, "rotate", lambda self, xs, hops=1: list(xs))
    res = _run("uniform2d_5m.ring_leapfrog")
    assert not res["correct"], res["checks"]
    assert res["checks"]["force_err"]["value"] > \
        res["checks"]["force_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_one_answer_altered(cell, monkeypatch):
    def wrap(fn):
        def altered(positions, masses):
            out = fn(positions, masses).clone()
            # One body's force moved by a tenth of the RMS force.
            out[SMALL_N // 3] += 0.1 * out.norm(dim=-1).pow(2).mean().sqrt()
            return out
        return altered
    _wrap_forces(monkeypatch, cell, wrap)
    res = _run(cell)
    assert not res["correct"], res["checks"]
