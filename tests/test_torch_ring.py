"""The port's ring brute force (nbody_tpu_torch.parallel.ring) on CPU
meshes against the JAX package's ring (nbody_tpu.parallel.ring) on the
virtual CPU devices of tests/conftest.py, on the same numpy bodies.

Tolerance: in f64 both rings run the same plain rows (the pair guard on)
over the same shard pairs; only the order of a few sums differs, so forces
agree to rtol 1e-10 (of the largest force). Engines are counted by
wrapping them: the Newton-3 ring launches P self blocks and, per forward
step, one tile per shard; at the even-P half step each tile is half of a
pair's rectangle, the other half on the pair's other shard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu as jnb
from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.parallel import mesh as jmesh
from nbody_tpu.parallel import ring as jring
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops import cuda_brute as cb
from nbody_tpu_torch.parallel import mesh as tmesh
from nbody_tpu_torch.parallel import ring as tring

torch.set_num_threads(2)

SOFT0 = {"G": 1.0, "softening": 0.0}


def _close(have, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(have), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _bodies(n, dim, seed, coincident=False):
    s = jnb.random_system(jax.random.key(seed), n, dim=dim,
                          dtype=jnp.float64)
    pos, mass = np.array(s.positions), np.array(s.masses)
    if coincident:  # bodies 0 and n-1 coincide, in different shards
        pos[-1] = pos[0]
    return pos, mass


def _meshes(p):
    return (jmesh.make_mesh(jax.devices()[:p]),
            tmesh.make_mesh([torch.device("cpu")] * p))


def _both(fn_j, fn_t, pos, mass, p, cfg, **kw):
    jm, tm = _meshes(p)
    want = fn_j(jnp.asarray(pos), jnp.asarray(mass), JGravity(**cfg),
                mesh=jm, **kw)
    have = fn_t(torch.from_numpy(pos), torch.from_numpy(mass),
                TGravity(**cfg), mesh=tm, **kw)
    assert have.shape == pos.shape and have.dtype == torch.float64
    return have.numpy(), want


@pytest.mark.parametrize("p,n", [(2, 256), (3, 300), (4, 300), (8, 256)])
def test_symmetric_ring_matches_jax(p, n):
    """Odd and even P; N = 300 pads the shards with zero-mass bodies."""
    pos, mass = _bodies(n, 3, seed=p)
    _close(*_both(jring.ring_brute_force, tring.ring_brute_force, pos, mass,
                  p, {}))


@pytest.mark.parametrize("p", [3, 4])
def test_symmetric_ring_softening_zero_coincident(p):
    """softening 0 with two coincident bodies in different shards: the
    pair guard holds across the ring."""
    pos, mass = _bodies(300, 2, seed=10 + p, coincident=True)
    have, want = _both(jring.ring_brute_force, tring.ring_brute_force, pos,
                       mass, p, SOFT0)
    assert np.all(np.isfinite(have))
    _close(have, want)


@pytest.mark.parametrize("n", [300])
def test_one_sided_ring_matches_jax(n):
    pos, mass = _bodies(n, 2, seed=20)
    _close(*_both(jring.ring_brute_force, tring.ring_brute_force, pos, mass,
                  4, {"softening": 1e5}, symmetric=False))


@pytest.mark.parametrize("p,n", [(3, 500), (4, 1000)])
def test_segmented_ring_matches_jax(p, n):
    """The JAX package's watchdog-bounded ring at a budget of 2^15 pairs,
    which splits each shard into row chunks, against the port's one
    Newton-3 ring, odd and even P; N is ragged, so the shards are
    padded."""
    budget = 1 << 15
    pos, mass = _bodies(n, 3, seed=30 + p)
    jm, tm = _meshes(p)
    want = jring.ring_all_pairs_segmented(
        jnp.asarray(pos), jnp.asarray(mass), JGravity(), mesh=jm,
        pair_budget=budget)
    have = tring.ring_brute_force(torch.from_numpy(pos),
                                  torch.from_numpy(mass), TGravity(), mesh=tm)
    assert have.shape == pos.shape and have.dtype == torch.float64
    _close(have.numpy(), want)


def _counting(fn, log, key):
    def wrapped(*a):
        log[key] += 1
        return fn(*a)
    return wrapped


@pytest.mark.parametrize("p,self_blocks,tiles", [(2, 2, 2), (3, 3, 3),
                                                 (4, 4, 8), (8, 8, 32)])
def test_symmetric_ring_engine_calls(p, self_blocks, tiles):
    """P self blocks; ⌈(P−1)/2⌉ steps of P tiles, the even-P half step's
    pairs split between their two shards: P·⌈(P−1)/2⌉ tiles, each
    unordered shard pair once (the test below checks the coverage)."""
    log = {"local": 0, "sym": 0}
    pos, mass = _bodies(16 * p, 3, seed=40)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    got = tring.ring_brute_force(
        tp, tm, TGravity(), mesh=_meshes(p)[1],
        local_accel=_counting(tring.plain_local_accel, log, "local"),
        sym_accel=_counting(tring.plain_sym_accel, log, "sym"))
    assert log == {"local": self_blocks, "sym": tiles}
    _close(got.numpy(), tring.ring_brute_force(tp, tm, TGravity(),
                                               mesh=_meshes(1)[1]).numpy())


def _recording(fn, index, calls):
    """``fn`` wrapped to log each call's (target, source) body indices,
    read back from the masses (distinct; 0 marks a padding body)."""
    def ids(m):
        return [index[v] for v in m.tolist() if v != 0.0]

    def wrapped(tpos, tmass, spos, smass, softening):
        calls.append((ids(tmass), ids(smass),
                      tpos.shape[0] * spos.shape[0]))
        return fn(tpos, tmass, spos, smass, softening)
    return wrapped


@pytest.mark.parametrize("one_device", [False, True])
@pytest.mark.parametrize("p", [2, 3, 4, 6])
def test_symmetric_ring_evaluates_each_cross_pair_once(p, one_device):
    """Every unordered pair of bodies in different shards is in exactly one
    two-output tile; at even P each pair of blocks (b, b + P/2) is two
    calls, whose areas differ by at most one row of a block, and every
    other pair of blocks one call. N is ragged, so the last shard holds a
    padding body. On a mesh of ``cpu:0..P-1`` and on ``[cpu] * P``."""
    rows = 10
    n = rows * p - 1
    pos, _ = _bodies(n, 3, seed=50 + p)
    mass = 1.0 + np.arange(n) / n
    index = {float(m): i for i, m in enumerate(mass)}
    mesh = tmesh.make_mesh([torch.device("cpu") if one_device else
                            torch.device("cpu", r) for r in range(p)])
    calls = []
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    got = tring.ring_brute_force(
        tp, tm, TGravity(), mesh=mesh,
        sym_accel=_recording(tring.plain_sym_accel, index, calls))
    seen = np.zeros((n, n), dtype=np.int64)
    per_pair = {}
    for t, u, area in calls:
        np.add.at(seen, np.ix_(t, u), 1)
        pair = frozenset((t[0] // rows, u[0] // rows))
        per_pair.setdefault(pair, []).append(area)
    block = np.arange(n) // rows
    cross = block[:, None] != block[None, :]
    both = seen + seen.T
    assert np.all(both[cross] == 1) and np.all(both[~cross] == 0)
    assert len(per_pair) == p * (p - 1) // 2
    for pair, areas in per_pair.items():
        a, b = sorted(pair)
        halves = p % 2 == 0 and b - a == p // 2
        assert len(areas) == (2 if halves else 1), (pair, areas)
        assert max(areas) - min(areas) <= rows
    _close(got.numpy(), tring.ring_brute_force(tp, tm, TGravity(),
                                               mesh=_meshes(1)[1]).numpy())
    want = jring.ring_brute_force(jnp.asarray(pos), jnp.asarray(mass),
                                  JGravity(), mesh=_meshes(p)[0])
    _close(got.numpy(), want)


def test_plain_engines_on_cpu_tensors():
    """Off the card (or off fp32) the engines are the plain rows in the
    tensors' dtype: K2 and K3 only for fp32 CUDA tensors."""
    for dt in (torch.float32, torch.float64):
        local, sym = tring._engines(torch.zeros((4, 3), dtype=dt), None,
                                    None)
        assert local is tring.plain_local_accel
        assert sym is tring.plain_sym_accel
    assert tring.plain_local_accel is not cb.local_accel_cuda


def test_ring_refuses_tensors_off_the_mesh_device():
    mesh = tmesh.Mesh((torch.device("cuda", 0),) * 2)
    with pytest.raises(ValueError):
        tring.ring_brute_force(torch.zeros((8, 2)), torch.ones(8),
                               TGravity(), mesh=mesh)
