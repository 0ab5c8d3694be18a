"""The radix BVH build (nbody_tpu_torch.ops.bvh.build_bvh and its bit
helpers) against nbody_tpu.ops.bvh on the same numpy bodies.

Tolerances: the tree's integer fields (sort order, node ranges, children)
equal the JAX package's exactly; in f64 the float fields (mass, COM, AABB
extent, quad moments and both packed tables) agree to rtol 1e-12, since both
packages run the same operations and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu as jnb
from nbody_tpu.ops import bvh as jb
from nbody_tpu.ops.grid_tree import _quad_pairs
from nbody_tpu_torch.ops import bvh as tb
from nbody_tpu_torch.ops.keys import MAX_BITS

# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)

_INT_FIELDS = ("order", "range_l", "range_r", "left", "right")
_FLOAT_FIELDS = ("pos_sorted", "mass_sorted", "node_mass", "node_com",
                 "node_size", "node_table", "body_table")


def _close(have, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(have), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _bodies(n, dim, seed, dtype=jnp.float64):
    s = jnb.random_system(jax.random.key(seed), n, dim=dim, dtype=dtype)
    return np.asarray(s.positions), np.asarray(s.masses)


def _both(pos, mass, quad):
    dim = pos.shape[1]
    kb = dim * MAX_BITS[dim]
    jt = jb.build_bvh(jnp.asarray(pos), jnp.asarray(mass), kb, quad=quad)
    tt = tb.build_bvh(torch.from_numpy(pos), torch.from_numpy(mass), kb,
                      quad=quad)
    return jt, tt


def _assert_same_tree(jt, tt, rtol=1e-12):
    assert tt.key_bits == jt.key_bits
    for f in _INT_FIELDS:
        have = getattr(tt, f)
        assert have.dtype == torch.int64
        np.testing.assert_array_equal(have.numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    for f in _FLOAT_FIELDS:
        have = getattr(tt, f)
        assert have.dtype == tt.pos_sorted.dtype, f
        _close(have.numpy(), getattr(jt, f), rtol)


_EDGES = [0, 1, 2, 3] + [v for k in range(2, 33)
                         for v in ((1 << k) - 1, 1 << k) if v < 1 << 32] \
    + [(1 << 32) - 1, 0x80000001, 12345, 0x00F0F0F0]


def test_clz32_matches_bit_length():
    x = torch.tensor(_EDGES, dtype=torch.int64)
    want = [32 - int(v).bit_length() for v in _EDGES]
    assert tb._clz32(x).tolist() == want
    # Bits above the low 32 are not part of the value.
    assert tb._clz32(x + (1 << 40)).tolist() == want


def test_floor_log2_is_exact():
    """Exact at every count up to 2^21 and at the uint32 edges; the JAX
    package's fp32 ``log2(count) + 1e-6`` (bvh.py:232-233) agrees below
    2^20 − 1 bodies and is one too large from there (a held finding: it
    only widens the AABB)."""
    counts = np.arange(1, 1 << 21, dtype=np.int64)
    exact = np.frexp(counts.astype(np.float64))[1] - 1
    have = tb._floor_log2(torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(have, exact)
    edges = [v for v in _EDGES if v > 0]
    assert tb._floor_log2(torch.tensor(edges)).tolist() == \
        [int(v).bit_length() - 1 for v in edges]
    jax_k = np.asarray(jax.jit(lambda c: jnp.floor(
        jnp.log2(c.astype(jnp.float32)) + 1e-6).astype(jnp.int32))(
        jnp.asarray(counts, jnp.int32)))
    first_bad = int(np.nonzero(jax_k != exact)[0][0]) + 1
    assert first_bad == (1 << 20) - 1
    assert jax_k[first_bad - 1] == exact[first_bad - 1] + 1


def test_delta_tiebreak_on_duplicate_keys():
    keys = torch.tensor([5, 5, 5, 7], dtype=torch.int64) << 28
    idx = torch.arange(4)
    i = torch.tensor([0, 1, 2, 0])
    j = torch.tensor([1, 2, 3, -1])
    # Equal keys fall through to index bits: 32 + clz(i ^ j).
    assert tb._delta(keys, idx, i, j, 4).tolist() == \
        [32 + 31, 32 + 30, 2, -1]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [5, 37, 256, 1000])
def test_quad_build_matches_jax(n, dim):
    pos, mass = _bodies(n, dim, seed=11 + n)
    jt, tt = _both(pos, mass, quad=True)
    _assert_same_tree(jt, tt)
    assert tt.node_table.shape == (2 * n - 1, 12 if dim == 2 else 16)


@pytest.mark.parametrize("bodies", ["dyadic", "reference_units"])
def test_mono_build_matches_jax(bodies):
    """Without quad, node mass and COM are prefix-sum differences, whose
    rounding follows the summation order (XLA's reduce-window scan against
    torch's running cumsum). On dyadic bodies (positions k/1024, integer
    masses) every prefix sum is exact in f64, so all fields agree to 1e-12.
    On the reference's units (masses up to 1e8, coordinates up to 1e7) the
    two differ by up to the prefix sums' own error: each entry of a running
    sum of n terms is within (n − 1)·eps·Σ|terms| of exact (read: 1.9e-10
    relative at N = 300, where the bound allows ~1e-9)."""
    n, dim = 300, 3
    if bodies == "dyadic":
        rng = np.random.default_rng(4)
        pos = rng.integers(0, 1024, (n, dim)) / 1024.0
        mass = rng.integers(1, 1001, n).astype(np.float64)
    else:
        pos, mass = _bodies(n, dim, seed=4)
    jt, tt = _both(pos, mass, quad=False)
    assert tt.node_table.shape == (2 * n - 1, 12)
    if bodies == "dyadic":
        _assert_same_tree(jt, tt)
        return
    for f in _INT_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    for f in ("pos_sorted", "mass_sorted", "node_size", "body_table"):
        _close(getattr(tt, f).numpy(), getattr(jt, f))
    # Two prefix entries per difference, each within (n-1)·eps·Σ|terms|,
    # in each package.
    eps = np.finfo(np.float64).eps
    m_node = np.asarray(jt.node_mass)
    err_m = 4 * n * eps * mass.sum()
    err_mx = 4 * n * eps * (mass[:, None] * np.abs(pos)).sum(0)
    com = np.asarray(jt.node_com)
    assert np.all(np.abs(tt.node_mass.numpy() - m_node) <= err_m)
    assert np.all(np.abs(tt.node_com.numpy() - com)
                  <= (err_mx + np.abs(com) * err_m) / m_node[:, None])
    np.testing.assert_array_equal(tt.node_table[:, :5].numpy(),
                                  np.asarray(jt.node_table[:, :5]))


def test_duplicate_positions_build_matches_jax():
    """Identical keys take the index-tiebreak path (Karras §4)."""
    pos, mass = _bodies(32, 2, seed=0)
    pos = np.concatenate([pos, pos[:8], pos[3:4], pos[3:4]])
    mass = np.concatenate([mass, mass[:8], mass[3:5]])
    jt, tt = _both(pos, mass, quad=True)
    _assert_same_tree(jt, tt)


def test_fp32_build_matches_jax():
    """On the same fp32 bodies the keys are bit-identical, so the tree's
    structure is too; the float fields agree to fp32 rounding."""
    pos, mass = _bodies(1000, 3, seed=2, dtype=jnp.float32)
    jt, tt = _both(pos, mass, quad=True)
    _assert_same_tree(jt, tt, rtol=1e-5)


def test_node_stats_match_f64_oracle():
    """Every node's size is its exact AABB extent, and its mass, COM and
    quad moments those of its body range (tests/test_bvh_build.py)."""
    n, dim = 200, 2
    pos, mass = _bodies(n, dim, seed=7)
    tt = tb.build_bvh(torch.from_numpy(pos), torch.from_numpy(mass),
                      dim * MAX_BITS[dim], quad=True)
    ps, ms = tt.pos_sorted.numpy(), tt.mass_sorted.numpy()
    rl, rr = tt.range_l.numpy(), tt.range_r.numpy()
    qpairs = _quad_pairs(dim)
    S = tt.node_table[:, 6 + dim:6 + dim + len(qpairs)].numpy()
    for v in range(2 * n - 1):
        x, m = ps[rl[v]:rr[v] + 1], ms[rl[v]:rr[v] + 1]
        np.testing.assert_allclose(tt.node_size[v].item(),
                                   (x.max(0) - x.min(0)).max(), rtol=1e-12)
        np.testing.assert_allclose(tt.node_mass[v].item(), m.sum(),
                                   rtol=1e-12)
        com = x[0] if len(x) == 1 else (m[:, None] * x).sum(0) / m.sum()
        np.testing.assert_allclose(tt.node_com[v].numpy(), com, rtol=1e-12)
        d = x - com
        want = [(m * d[:, a] * d[:, b]).sum() for a, b in qpairs]
        np.testing.assert_allclose(S[v], want, rtol=1e-8, atol=1e-10)
