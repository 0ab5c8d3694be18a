"""K5's plain version and ``sort=True`` (nbody_tpu_torch.ops.cuda_brute)
against the JAX Pallas mxu kernel, run in interpret mode, and the f64
oracle.

K5 itself runs only on the card (``chip_smoke.py``); here the wrappers get
CPU tensors and take their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import GravityConfig as JGravity
from nbody_tpu.ops.brute_force import brute_force_direct
from nbody_tpu.ops.pallas_brute import brute_force_pallas, pairwise_accel_pallas
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops import cuda_brute as cb
from nbody_tpu_torch.utils.accuracy import scale_normalized_error


def _bodies(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 1e7, size=(n, dim)).astype(np.float32)
    mass = rng.uniform(1.0, 1e8, size=n).astype(np.float32)
    return pos, mass


def _oracle64(pos, mass):
    return np.asarray(brute_force_direct(
        jnp.asarray(pos, jnp.float64), jnp.asarray(mass, jnp.float64),
        JGravity()))


def _err(have, want):
    return float(scale_normalized_error(have, np.asarray(want)))


# The bounds of the JAX package's own mxu tests (tests/test_pallas_brute.py
# :109, :131): the block-centred reduction cancels at |x_t − c|·Σw scale, so
# it is held to its documented envelope, not to the precise kernels' 1e-4.
# Port and JAX differ by the same envelope (centring form, summation order).
@pytest.mark.parametrize("n,sort,tol", [(256, False, 5e-3),
                                        (512, False, 3e-4),
                                        (512, True, 3e-4)])
def test_mxu_matches_pallas_and_oracle(n, sort, tol):
    pos, mass = _bodies(n, 3, seed=n)
    want = brute_force_pallas(jnp.asarray(pos), jnp.asarray(mass), JGravity(),
                              block_t=64, block_s=128, mode="mxu", sort=sort,
                              interpret=True)
    have = cb.brute_force_cuda(torch.from_numpy(pos), torch.from_numpy(mass),
                               TGravity(), mode="mxu", sort=sort, block_t=64)
    assert have.dtype == torch.float32 and have.shape == (n, 3)
    assert bool(torch.isfinite(have).all())
    assert _err(have, _oracle64(pos, mass)) < tol
    assert _err(have, want) < tol


def test_mxu_default_block_is_256_clamped_to_n():
    """block_t defaults to 256, clamped to N rounded up to 128 (one centring
    block here), as brute_force_pallas does."""
    pos, mass = _bodies(200, 3, seed=4)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    have = cb.brute_force_cuda(tp, tm, TGravity(), mode="mxu")
    want = (TGravity().G * tm)[:, None] * cb.mxu_accel_plain(
        tp, tp, tm, TGravity().softening, block_t=256)
    assert torch.equal(have, want)
    want_jax = brute_force_pallas(jnp.asarray(pos), jnp.asarray(mass),
                                  JGravity(), mode="mxu", interpret=True)
    assert _err(have, want_jax) < 3e-4


def test_pairwise_mxu_matches_pallas():
    """The rectangular tile in mxu mode: ragged targets (a short last
    centring block) and a source count no multiple of any tile, against the
    f64 one-sided sum."""
    tpos, _ = _bodies(100, 2, seed=1)
    spos, smass = _bodies(700, 2, seed=2)
    want = pairwise_accel_pallas(jnp.asarray(tpos), jnp.asarray(spos),
                                 jnp.asarray(smass), softening=0.0,
                                 block_t=64, mode="mxu", interpret=True)
    have = cb.pairwise_accel_cuda(torch.from_numpy(tpos),
                                  torch.from_numpy(spos),
                                  torch.from_numpy(smass), softening=0.0,
                                  mode="mxu", block_t=64)
    assert have.shape == (100, 2)
    t, s, m = (a.astype(np.float64) for a in (tpos, spos, smass))
    diff = s[None, :, :] - t[:, None, :]
    d2 = np.sum(diff * diff, axis=-1)
    w = np.where(d2 < 1e-10, 0.0, m[None, :] * d2 ** -1.5)
    want64 = np.sum(w[..., None] * diff, axis=1)
    # Unsorted blocks spread over the whole box: the N = 256 bound (5e-3).
    assert _err(have, want64) < 5e-3
    assert _err(have, want) < 5e-3


def test_mxu_centred_form_is_exact_in_f64():
    """In f64 the centred reduction equals the one-sided sum for any block
    size: a[:D] − (x_t − c)·a[D] = Σ m_s·u³·(x_s − x_t)."""
    pos, mass = _bodies(300, 3, seed=6)
    p, m = torch.from_numpy(pos).double(), torch.from_numpy(mass).double()
    want = cb.pairwise_accel_plain(p, p, m, 0.0, guard=True)
    for block_t in (1, 64, 256, 1024):
        have = cb.mxu_accel_plain(p, p, m, 0.0, block_t=block_t)
        np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=1e-9,
                                   atol=1e-9 * float(want.abs().max()))


@pytest.mark.parametrize("mode", ["precise", "symmetric"])
def test_sort_matches_pallas_and_unsorted(dim, mode):
    """sort=True (Morton order, stable argsort, scatter back) for the other
    modes: same forces as unsorted, in the caller's order."""
    pos, mass = _bodies(300, dim, seed=dim)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    have = cb.brute_force_cuda(tp, tm, TGravity(), mode=mode, sort=True)
    kw = {"block_t": 128, "s_sub": 128} if mode == "symmetric" else {}
    want = brute_force_pallas(jnp.asarray(pos), jnp.asarray(mass), JGravity(),
                              mode=mode, sort=True, interpret=True, **kw)
    assert _err(have, want) < 1e-5
    assert _err(have, cb.brute_force_cuda(tp, tm, TGravity(), mode=mode)) \
        < 1e-5
    assert _err(have, _oracle64(pos, mass)) < 1e-4


def test_mxu_rejects_block_over_one_cta():
    tp, tm = torch.zeros((1100, 3)), torch.ones(1100)
    with pytest.raises(ValueError, match="block_t"):
        cb.pairwise_accel_cuda(tp, tp, tm, mode="mxu", block_t=2048)


def test_mxu_cpu_tensors_launch_nothing():
    pos, mass = _bodies(64, 3)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    before = dict(cb.LAUNCHES)
    cb.brute_force_cuda(tp, tm, mode="mxu", sort=True)
    cb.pairwise_accel_cuda(tp, tp, tm, mode="mxu")
    assert cb.LAUNCHES == before
