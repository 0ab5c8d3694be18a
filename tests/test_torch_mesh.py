"""The port's device mesh (nbody_tpu_torch.parallel.mesh): its collectives
on lists of per-shard tensors, the body split and the device checks;
all_to_all, pmin and pmax also against ``jax.lax``'s under ``shard_map``
on 4 of the virtual CPU devices of tests/conftest.py.

Tolerance: exact. The collectives only move and add tensors, on small int
and float tensors whose sums are exact, except where a test fixes the
order of a float sum on purpose.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from nbody_tpu_torch.parallel import mesh as pm

CPU = torch.device("cpu")


def _mesh(p):
    return pm.make_mesh([CPU] * p)


def _shards(p, dtype=torch.int64):
    return [torch.arange(3, dtype=dtype).reshape(3, 1) + 10 * r
            for r in range(p)]


def test_make_mesh_lists_devices_and_shards():
    m = _mesh(4)
    assert m.num_shards == 4 and m.device_type == "cpu"
    assert m.devices == (CPU,) * 4
    assert m.distinct_devices == [CPU]
    assert pm.BODY_AXIS == "x"
    assert pm.pad_to_multiple(10, 4) == 12 and pm.pad_to_multiple(8, 4) == 8


def test_make_mesh_default_needs_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh()
    assert pm.default_num_shards() == 0


def test_mesh_refuses_empty_and_mixed_devices():
    with pytest.raises(ValueError):
        pm.Mesh(())
    with pytest.raises(ValueError):
        pm.Mesh((CPU, torch.device("cuda", 0)))


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_ppermute_and_rotate_move_each_shard(p):
    m = _mesh(p)
    xs = _shards(p)
    fwd = m.ppermute(xs, [(i, (i + 1) % p) for i in range(p)])
    for r in range(p):
        assert torch.equal(fwd[r], xs[(r - 1) % p])
    back = m.rotate(fwd, -1)
    for r in range(p):
        assert torch.equal(back[r], xs[r])
    two = m.rotate(xs, 2)
    for r in range(p):
        assert torch.equal(two[r], xs[(r - 2) % p])


def test_ppermute_gives_zeros_to_a_shard_that_receives_nothing():
    m = _mesh(3)
    xs = _shards(3, torch.float32)
    out = m.ppermute(xs, [(0, 1)])
    assert torch.equal(out[1], xs[0])
    assert torch.equal(out[0], torch.zeros_like(xs[0]))
    assert torch.equal(out[2], torch.zeros_like(xs[2]))


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_psum_and_all_gather_are_exact(dtype):
    m = _mesh(4)
    xs = _shards(4, dtype)
    total = m.psum(xs)
    want = sum(x.clone() for x in xs)
    assert len(total) == 4
    for t in total:
        assert torch.equal(t, want)
    # Shards of one device share one result object.
    assert all(t is total[0] for t in total)
    gathered = m.all_gather(xs)
    for g in gathered:
        assert torch.equal(g, torch.cat(xs))
    assert all(g is gathered[0] for g in gathered)
    one = _mesh(1).all_gather(xs[:1])
    assert len(one) == 1 and torch.equal(one[0], xs[0])


def test_psum_adds_in_shard_order():
    """In f64, (1 + 1e16) − 1e16 is 0 and (1e16 − 1e16) + 1 is 1: the sum
    runs over shards 0 to P−1, so the result is fixed by the shard order."""
    m = _mesh(3)
    xs = [torch.tensor([v], dtype=torch.float64) for v in (1.0, 1e16, -1e16)]
    assert float(m.psum(xs)[0]) == 0.0
    assert float(m.psum([xs[1], xs[2], xs[0]])[0]) == 1.0


def test_reduce_leaves_the_sum_on_the_first_device():
    """reduce is psum without the copies: one tensor, the same sum in the
    same shard order."""
    m = _mesh(3)
    xs = [torch.tensor([v], dtype=torch.float64) for v in (1.0, 1e16, -1e16)]
    total = m.reduce(xs)
    assert isinstance(total, torch.Tensor) and total.device == CPU
    assert torch.equal(total, m.psum(xs)[0]) and float(total) == 0.0
    assert float(m.reduce([xs[1], xs[2], xs[0]])) == 1.0


def test_ops_and_utils_import_nothing_of_parallel():
    """The layers run one way: parallel/ builds on ops/ and utils/ (the
    Mesh type lives in utils/device_mesh.py), never the reverse."""
    pkg = pathlib.Path(pm.__file__).resolve().parent.parent
    for sub in ("ops", "utils"):
        for path in sorted((pkg / sub).glob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.ImportFrom):
                    names = [node.module or ""] + [a.name
                                                   for a in node.names]
                elif isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                else:
                    continue
                for name in names:
                    assert "parallel" not in name.split("."), (path, name)


def test_shard_bodies_splits_the_leading_axis():
    m = _mesh(4)
    pos = torch.arange(24, dtype=torch.float64).reshape(8, 3)
    mass = torch.arange(8, dtype=torch.float64)
    ps, ms = pm.shard_bodies(m, pos, mass)
    assert [tuple(p.shape) for p in ps] == [(2, 3)] * 4
    assert torch.equal(torch.cat(ps), pos) and torch.equal(torch.cat(ms),
                                                           mass)
    only = pm.shard_bodies(m, mass)
    assert isinstance(only, list) and len(only) == 4
    with pytest.raises(ValueError, match="split evenly"):
        pm.shard_bodies(m, torch.zeros(10))


def test_replicate_and_per_device_run_once_per_device():
    m = _mesh(4)
    x = torch.ones(3)
    copies = m.replicate(x)
    assert len(copies) == 4 and all(c is copies[0] for c in copies)
    calls = []
    out = m.per_device(lambda r: calls.append(r) or x * 2)
    assert calls == [0] and all(o is out[0] for o in out)
    np.testing.assert_array_equal(out[0].numpy(), [2.0, 2.0, 2.0])
    assert m.per_shard(lambda r: r * 10) == [0, 10, 20, 30]


def test_a_cuda_mesh_refuses_cpu_tensors():
    """No silent move between kinds of device: a CPU tensor given to a
    mesh of CUDA devices raises before anything runs."""
    m = pm.Mesh((torch.device("cuda", 0),) * 2)
    with pytest.raises(ValueError, match="cpu"):
        m.check(torch.zeros(4))
    with pytest.raises(ValueError):
        pm.shard_bodies(m, torch.zeros(4))
    with pytest.raises(ValueError):
        m.psum([torch.zeros(2), torch.zeros(2)])


def _jax_collective(fn, x):
    """``fn`` under ``shard_map`` over 4 CPU devices on the [4, ...] numpy
    array ``x`` (shard r holds x[r]); returns [4, ...]."""
    jm = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("x",))
    out = jax.shard_map(lambda a: fn(a[0])[None], mesh=jm, in_specs=JP("x"),
                        out_specs=JP("x"))(x)
    return np.asarray(out)


def test_all_to_all_matches_jax():
    """Shard r receives the stack of every shard's row r
    (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``)."""
    p = 4
    x = np.arange(p * p * 3 * 2, dtype=np.int64).reshape(p, p, 3, 2)
    want = _jax_collective(lambda a: jax.lax.all_to_all(a, "x", 0, 0), x)
    got = _mesh(p).all_to_all([torch.from_numpy(x[r]) for r in range(p)])
    assert [tuple(g.shape) for g in got] == [(p, 3, 2)] * p
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


@pytest.mark.parametrize("op", ["pmin", "pmax"])
def test_pmin_pmax_match_jax(op):
    """Elementwise over the shards, the same tensor on every shard."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 3))
    want = _jax_collective(lambda a: getattr(jax.lax, op)(a, "x"), x)
    m = _mesh(4)
    got = getattr(m, op)([torch.from_numpy(x[r]) for r in range(4)])
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    assert all(g is got[0] for g in got)  # one object per device


def test_all_to_all_refuses_a_leading_axis_other_than_the_shards():
    with pytest.raises(ValueError, match="leading axis"):
        _mesh(4).all_to_all([torch.zeros(3, 2)] * 4)
