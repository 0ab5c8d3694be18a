"""K3's plain version and the segmented driver (nbody_tpu_torch.ops.
cuda_brute) against the JAX Pallas sym tile and segmented driver, run in
interpret mode, and the f64 oracle.

K3 itself runs only on the card (``chip_smoke.py``); here the wrappers get
CPU tensors and take their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.ops.brute_force import brute_force_direct
from nbody_tpu.ops.pallas_brute import (brute_force_pallas_segmented,
                                        pallas_sym_tile)
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops import cuda_brute as cb
from nbody_tpu_torch.utils.accuracy import scale_normalized_error


# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)


def _bodies(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 1e7, size=(n, dim)).astype(np.float32)
    mass = rng.uniform(1.0, 1e8, size=n).astype(np.float32)
    return pos, mass


def _assert_tile_close(have, want):
    """rtol 2e-5 and atol 2e-5 of the largest |value|: the bound of the JAX
    package's own sym-tile tests (tests/test_ring.py:80-117)."""
    for h, w in zip(have, want):
        w = np.asarray(w)
        assert h.dtype == torch.float32 and h.shape == w.shape
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(h.numpy(), w, rtol=2e-5, atol=2e-5 * scale)


@pytest.mark.parametrize("t,dim,jax_kw", [
    (100, 2, {"block_t": 64, "s_sub": 128}),
    (130, 3, {"block_t": 32, "s_sub": 64, "chunk": 64}),
])
def test_sym_tile_plain_matches_pallas(t, dim, jax_kw):
    pos, mass = _bodies(300, dim, seed=t)
    split = [pos[:t], mass[:t], pos[t:], mass[t:]]
    want = pallas_sym_tile(*map(jnp.asarray, split), softening=0.0,
                           interpret=True, **jax_kw)
    tp = [torch.from_numpy(a) for a in split]
    have = cb.sym_tile_plain(*tp, softening=0.0)
    _assert_tile_close(have, want)
    # The chunked split (both axes, ragged tails) changes neither output.
    _assert_tile_close(cb.sym_tile_cuda(*tp, softening=0.0, chunk=64),
                       [h.numpy() for h in have])


def test_sym_tile_matches_one_sided_sums():
    """The two outputs are the one-sided sums of the same pair set (f64)."""
    pos, mass = _bodies(250, 3, seed=3)
    p, m = torch.from_numpy(pos).double(), torch.from_numpy(mass).double()
    acc_t, part_s = cb.sym_tile_plain(p[:90], m[:90], p[90:], m[90:],
                                      softening=1e-6, chunk=40)
    np.testing.assert_allclose(
        acc_t.numpy(),
        cb.pairwise_accel_plain(p[:90], p[90:], m[90:], 1e-6).numpy(),
        rtol=1e-10)
    np.testing.assert_allclose(
        part_s.numpy(),
        cb.pairwise_accel_plain(p[90:], p[:90], m[:90], 1e-6).numpy(),
        rtol=1e-10)


def test_sym_accel_adapter_and_guard():
    """sym_accel_cuda is the softening-only adapter; at softening 0 the guard
    keeps coincident bodies finite."""
    pos = np.zeros((6, 2), np.float32)
    pos[:, 0] = [0.0, 1.0, 2.0, 0.0, 5.0, 7.0]  # target 0 == source 0
    mass = np.ones(6, np.float32)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    acc_t, part_s = cb.sym_accel_cuda(tp[:3], tm[:3], tp[3:], tm[3:], 0.0)
    assert bool(torch.isfinite(acc_t).all() and torch.isfinite(part_s).all())
    want = cb.sym_tile_plain(tp[:3], tm[:3], tp[3:], tm[3:], guard=True)
    for h, w in zip((acc_t, part_s), want):
        assert torch.equal(h, w)


@pytest.mark.parametrize("n,num_segments", [(500, 3), (384, 2), (129, 4),
                                            (256, 1)])
def test_segmented_matches_pallas_and_oracle(dim, n, num_segments):
    pos, mass = _bodies(n, dim, seed=n + dim)
    want = brute_force_pallas_segmented(jnp.asarray(pos), jnp.asarray(mass),
                                        JGravity(), num_segments=num_segments,
                                        interpret=True)
    want64 = brute_force_direct(jnp.asarray(pos, jnp.float64),
                                jnp.asarray(mass, jnp.float64), JGravity())
    have = cb.brute_force_cuda_segmented(torch.from_numpy(pos),
                                         torch.from_numpy(mass), TGravity(),
                                         num_segments=num_segments)
    assert have.dtype == torch.float32 and have.shape == (n, dim)
    assert float(scale_normalized_error(have, np.asarray(want))) < 1e-4
    assert float(scale_normalized_error(have, np.asarray(want64))) < 1e-4


def test_segmented_default_is_one_segment_below_2_20():
    pos, mass = _bodies(200, 2, seed=9)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    assert torch.equal(cb.brute_force_cuda_segmented(tp, tm),
                       cb.brute_force_cuda(tp, tm, mode="symmetric"))


def test_cpu_tensors_launch_nothing():
    pos, mass = _bodies(300, 3)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    before = dict(cb.LAUNCHES)
    cb.sym_tile_cuda(tp[:100], tm[:100], tp[100:], tm[100:])
    cb.brute_force_cuda_segmented(tp, tm, num_segments=3)
    cb.local_accel_cuda(tp[:10], tp, tm, 1e-6)
    assert cb.LAUNCHES == before
