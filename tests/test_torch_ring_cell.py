"""The ring cell's path on CPU meshes: ``Simulation`` leapfrog with the
Newton-3 ring as its ``forces_fn`` (as ``benchmark/run.py`` builds it for
the ring mix) against the benchmark's float64 reference step, and the
ring's spans and counters (``parallel/ring.py``).

A mesh of ``cpu:0 .. cpu:P-1`` stands for P cards: the tensors stay on the
one CPU, but the ring counts a move between two of these devices as bytes
that leave their card, as between two CUDA cards. ``[cpu] * P`` is P
shards on one device, where nothing leaves a card.
"""

import dataclasses
import functools

import pytest
import torch

from benchmark import reference
from nbody_tpu_torch.config import GravityConfig
from nbody_tpu_torch.parallel import mesh as tmesh
from nbody_tpu_torch.parallel import ring
from nbody_tpu_torch.simulation import Simulation
from nbody_tpu_torch.state import System
from nbody_tpu_torch.utils import profiling

torch.set_num_threads(2)

G, SOFT, DT = 1.0, 0.05, 1e-3
# The ring and the reference sum the same float64 pair terms in another
# order (self blocks, Newton-3 tiles and the return pass against whole
# rows): a sum of N ≈ 1e3 terms then differs by at most some N·2^-53 ≈
# 1e-13 of the largest (5.7e-15 read over these cases), so 1e-12 of each
# quantity's largest magnitude is over any rounding, while one missing or
# doubled block moves a force by ~1/P.
RTOL = 1e-12


@pytest.fixture(autouse=True)
def spans_off():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _bodies(n, dim, seed, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, dim), generator=gen, dtype=dtype)
    vel = (torch.rand((n, dim), generator=gen, dtype=dtype) - 0.5) * 0.2
    mass = (torch.rand((n,), generator=gen, dtype=dtype) + 0.5) / n
    return pos, vel, mass


def _cards(p):
    return tmesh.make_mesh([torch.device("cpu", r) for r in range(p)])


def _one_device(p):
    return tmesh.make_mesh([torch.device("cpu")] * p)


def _close(have, want):
    scale = float(want.abs().max())
    err = float((have - want).abs().max())
    assert err <= RTOL * scale, (err, scale)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [1000, 1001])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_simulation_ring_leapfrog_matches_reference(p, n, dim):
    """Three leapfrog steps through ``Simulation.run``, each judged by the
    reference from the program's own state before it; one ring call a step
    after the first, the carry handing back F(x0)."""
    pos, vel, mass = _bodies(n, dim, seed=100 * p + n + dim)
    gravity = GravityConfig(G=G, softening=SOFT)
    calls = []
    ring_fn = functools.partial(ring.ring_brute_force, config=gravity,
                                mesh=_cards(p))

    def forces_fn(positions, masses):
        out = ring_fn(positions, masses)
        calls.append((positions, out))
        return out

    sim = Simulation.create(System(pos, vel, mass), gravity, method="brute",
                            integrator="leapfrog")
    sim = dataclasses.replace(sim, forces_fn=forces_fn)
    rows = torch.arange(n)
    for step in range(3):
        before, seen = sim.system, len(calls)
        sim = sim.run(steps=1, dt=DT)
        after = sim.system
        assert len(calls) - seen == (2 if step == 0 else 1)
        ref = reference.leapfrog_rows(before.positions, before.velocities,
                                      mass, after.positions, rows, DT, G,
                                      SOFT)
        for positions, forces in calls[seen:]:
            _close(forces, reference.forces_on_rows(positions, mass, rows,
                                                    G, SOFT))
        _close(after.positions, ref["x1"])
        _close(after.velocities, ref["v1"])
        _close(after.velocities - before.velocities,
               ref["v1"] - ref["v0"])
    assert len(calls) == 4


def _tiles_of(p, r):
    """Shard r's two-output tiles a call: one a forward step, ⌈(P−1)/2⌉
    steps; at even P the last is its half of a pair's rectangle."""
    return p // 2


def _ring_bytes(n, dim, p, itemsize, cards, one_sided=False):
    """Bytes that leave their card in one call: the scatter of (positions,
    masses) to the P − 1 shards off the bodies' card, the rotations (every
    shard's block a hop: P // 2 forward of (positions, masses) and as many
    return hops of [rows, D] shares; the one-sided ring P − 1 forward),
    and the gather of the [rows, D] forces. The ring cell's 5e6 2D fp32
    bodies on four cards: 275,000,000."""
    if not cards:
        return 0
    rows = -(-n // p)
    body, share = rows * (dim + 1) * itemsize, rows * dim * itemsize
    if one_sided:
        hops = (p - 1) * p * body
    else:
        hops = p // 2 * p * (body + share)
    return (p - 1) * body + hops + (p - 1) * share


@pytest.mark.parametrize("cards", [True, False])
@pytest.mark.parametrize("dim,dtype", [(2, torch.float64),
                                       (3, torch.float32)])
@pytest.mark.parametrize("p", [3, 4])
def test_newton3_ring_spans_and_counters(p, dim, dtype, cards):
    n = 1001
    pos, _, mass = _bodies(n, dim, seed=7, dtype=dtype)
    mesh = _cards(p) if cards else _one_device(p)
    profiling.enable_spans()
    for _ in range(2):
        ring.ring_brute_force(pos, mass, GravityConfig(), mesh=mesh)
    spans = profiling.span_totals()
    assert {r: spans[f"ring.self/{r}"][1] for r in range(p)} == \
        {r: 2 for r in range(p)}
    assert {r: spans.get(f"ring.tile/{r}", (0.0, 0))[1]
            for r in range(p)} == {r: 2 * _tiles_of(p, r) for r in range(p)}
    assert profiling.counter_totals() == {
        "ring.tiles": 2 * sum(_tiles_of(p, r) for r in range(p)),
        "ring.hops": 2 * 2 * (p // 2),
        "ring.bytes": 2 * _ring_bytes(n, dim, p, pos.element_size(), cards)}


@pytest.mark.parametrize("cards", [True, False])
@pytest.mark.parametrize("p", [3, 4])
def test_one_sided_ring_spans_and_counters(p, cards):
    n, dim = 1001, 2
    pos, _, mass = _bodies(n, dim, seed=8)
    profiling.enable_spans()
    ring.ring_brute_force(pos, mass, GravityConfig(),
                          mesh=_cards(p) if cards else _one_device(p),
                          local_accel=ring.plain_local_accel)
    spans = profiling.span_totals()
    assert sorted(spans) == [f"ring.self/{r}" for r in range(p)]
    assert all(calls == p for _, calls in spans.values())
    assert profiling.counter_totals() == {
        "ring.hops": p - 1,
        "ring.bytes": _ring_bytes(n, dim, p, 8, cards, one_sided=True)}


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("p", [3, 4])
def test_spans_off_leave_the_registry_empty_and_the_forces_as_on(
        p, symmetric):
    pos, _, mass = _bodies(1001, 3, seed=9)
    kw = {} if symmetric else {"local_accel": ring.plain_local_accel}
    call = functools.partial(ring.ring_brute_force, pos, mass,
                             GravityConfig(), mesh=_cards(p), **kw)
    off = call()
    assert profiling.span_totals() == {}
    assert profiling.counter_totals() == {}
    profiling.enable_spans()
    on = call()
    assert profiling.counter_totals()["ring.hops"] > 0
    assert torch.equal(off, on)
