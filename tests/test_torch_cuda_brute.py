"""Plain versions of the CUDA kernels K1/K2 (nbody_tpu_torch.ops.cuda_brute)
against the JAX Pallas kernels they port, run in interpret mode.

The CUDA kernels themselves run only on the card (``chip_smoke.py``); here
the wrappers get CPU tensors and take their plain versions.
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


def _coincident(n=64):
    rng = np.random.default_rng(5)
    pos = np.concatenate([[[1.0, 1.0, 1.0]] * 2 + [[5.0, 1.0, 1.0]],
                          rng.uniform(10, 20, size=(n - 3, 3))])
    return pos.astype(np.float32), np.ones(n, np.float32)


def _oracle64(pos, mass, cfg):
    return np.asarray(brute_force_direct(
        jnp.asarray(pos, jnp.float64), jnp.asarray(mass, jnp.float64),
        JGravity(**cfg)))


def _check(have, want_jax, want64):
    assert have.dtype == torch.float32
    assert have.shape == want64.shape
    assert bool(torch.isfinite(have).all())
    assert float(scale_normalized_error(have, want_jax)) < 1e-5
    assert float(scale_normalized_error(have, want64)) < 1e-4


@pytest.mark.parametrize("n,dim", [(96, 2), (96, 3), (256, 3), (100, 3)])
def test_precise_matches_pallas(n, dim):
    pos, mass = _bodies(n, dim)
    want = brute_force_pallas(jnp.asarray(pos), jnp.asarray(mass), JGravity(),
                              block_t=64, block_s=128, interpret=True)
    have = cb.brute_force_cuda(torch.from_numpy(pos), torch.from_numpy(mass),
                               TGravity(), mode="precise")
    _check(have, np.asarray(want), _oracle64(pos, mass, {}))


@pytest.mark.parametrize("n,block,dim", [(96, 32, 3), (256, 64, 3),
                                         (100, 64, 3), (320, 64, 3),
                                         (64, 64, 3), (384, 128, 2)])
def test_symmetric_matches_pallas(n, block, dim):
    """Even, odd and single block counts, ragged N (zero-mass padding on the
    JAX side, short last block on the port's)."""
    pos, mass = _bodies(n, dim, seed=n)
    want = brute_force_pallas(jnp.asarray(pos), jnp.asarray(mass), JGravity(),
                              block_t=block, mode="symmetric", s_sub=block,
                              interpret=True)
    have = cb.symmetric_forces_plain(torch.from_numpy(pos),
                                     torch.from_numpy(mass), TGravity(),
                                     block=block)
    _check(have, np.asarray(want), _oracle64(pos, mass, {}))


@pytest.mark.parametrize("mode,block", [("precise", None), ("symmetric", 32)])
def test_coincident_guarded(mode, block):
    """softening == 0 turns the pair guard on: coincident bodies stay finite."""
    pos, mass = _coincident()
    cfg = {"G": 1.0, "softening": 0.0}
    kw = {"block_t": block, "s_sub": block} if block else {"block_t": 64,
                                                          "block_s": 64}
    want = brute_force_pallas(jnp.asarray(pos), jnp.asarray(mass),
                              JGravity(**cfg), mode=mode, interpret=True, **kw)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    have = (cb.symmetric_forces_plain(tp, tm, TGravity(**cfg), block=block)
            if block else cb.brute_force_cuda(tp, tm, TGravity(**cfg),
                                              mode=mode))
    _check(have, np.asarray(want), _oracle64(pos, mass, cfg))


def test_rect_tile_odd_source_count():
    """pairwise_accel with a source count that is no multiple of any tile."""
    tpos, _ = _bodies(64, 2, seed=1)
    spos, smass = _bodies(2500, 2, seed=2)
    want = pairwise_accel_pallas(jnp.asarray(tpos), jnp.asarray(spos),
                                 jnp.asarray(smass), softening=0.0,
                                 interpret=True)
    have = cb.pairwise_accel_cuda(torch.from_numpy(tpos),
                                  torch.from_numpy(spos),
                                  torch.from_numpy(smass), softening=0.0)
    t, s, m = (a.astype(np.float64) for a in (tpos, spos, smass))
    diff = s[None, :, :] - t[:, None, :]
    d2 = np.sum(diff * diff, axis=-1)
    w = np.where(d2 < 1e-10, 0.0, m[None, :] * d2 ** -1.5)
    want64 = np.sum(w[..., None] * diff, axis=1)
    _check(have, np.asarray(want), want64)


def test_guard_policy_default():
    """Guard only at softening == 0 (pallas_brute.py:48-60): at softening > 0
    a nearly coincident distinct pair (d² < 1e-10) feels the softened force,
    as in the Pallas kernel, where the always-guarding oracle skips it."""
    pos = np.zeros((8, 3), np.float32)
    pos[1, 0] = 1e-6
    pos[2:, 0] = np.arange(2, 8, dtype=np.float32)
    mass = np.ones(8, np.float32)
    cfg = {"G": 1.0, "softening": 1e-3}
    want = np.asarray(brute_force_pallas(jnp.asarray(pos), jnp.asarray(mass),
                                         JGravity(**cfg), interpret=True))
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    guarded = _oracle64(pos, mass, cfg)
    for mode in ("precise", "symmetric"):
        have = cb.brute_force_cuda(tp, tm, TGravity(**cfg), mode=mode)
        np.testing.assert_allclose(have.numpy(), want, rtol=1e-5, atol=1e-6)
        assert abs(float(have[0, 0]) - guarded[0, 0]) > 100.0
        forced = cb.brute_force_cuda(tp, tm, TGravity(**cfg), mode=mode,
                                     guard=True)
        np.testing.assert_allclose(forced.numpy(), guarded, rtol=1e-5)


def test_cpu_tensors_take_plain_path_without_launches():
    pos, mass = _bodies(64, 3)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    before = dict(cb.LAUNCHES)
    cb.brute_force_cuda(tp, tm, mode="precise")
    cb.brute_force_cuda(tp, tm, mode="symmetric")
    cb.pairwise_accel_cuda(tp, tp, tm)
    assert cb.LAUNCHES == before


def test_bad_and_unported_modes():
    tp, tm = torch.zeros((4, 3)), torch.ones(4)
    with pytest.raises(ValueError, match="mode must be"):
        cb.brute_force_cuda(tp, tm, mode="fast")
    with pytest.raises(ValueError, match="mode must be"):
        cb.pairwise_accel_cuda(tp, tp, tm, mode="symmetric")
    with pytest.raises(ValueError, match="devices"):
        cb.pairwise_accel_cuda(tp, tp.to("meta"), tm)


@pytest.mark.parametrize("nb", [1, 2, 5, 64])
def test_tri_pair_enumerates_each_block_pair_once(nb):
    pairs = [cb._tri_pair(k) for k in range(nb * (nb + 1) // 2)]
    assert sorted(pairs) == [(a, b) for a in range(nb) for b in range(a + 1)]


@pytest.fixture
def spans():
    """The span registry empty and off before and after the test."""
    from nbody_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield profiling
    profiling.reset_spans()


@pytest.mark.parametrize("spans_on", [True, False])
@pytest.mark.parametrize("n,dim,mode", [(200, 2, "precise"),
                                        (256, 2, "symmetric"),
                                        (300, 2, "symmetric"),
                                        (200, 3, "precise"),
                                        (300, 3, "symmetric")])
def test_routed_entry_takes_k2_below_and_k1_from_threshold(
        monkeypatch, spans, n, dim, mode, spans_on):
    """K2 below K1_MIN_N, K1 from it up; either route the JAX package's
    brute sum to 1e-5 of the RMS force; one counter a call with spans on,
    none with them off."""
    monkeypatch.setattr(cb, "K1_MIN_N", 256)
    modes = []
    inner = cb.brute_force_cuda

    def spy(positions, masses, config, mode):
        modes.append(mode)
        return inner(positions, masses, config, mode=mode)

    monkeypatch.setattr(cb, "brute_force_cuda", spy)
    if spans_on:
        spans.enable_spans()
    pos, mass = _bodies(n, dim, seed=n + dim)
    have = cb.brute_force_routed(torch.from_numpy(pos),
                                 torch.from_numpy(mass), TGravity())
    assert modes == [mode]
    want = brute_force_direct(jnp.asarray(pos), jnp.asarray(mass), JGravity())
    _check(have, np.asarray(want), _oracle64(pos, mass, {}))
    kernel = {"precise": "brute.k2", "symmetric": "brute.k1"}[mode]
    assert spans.counter_totals() == ({kernel: 1} if spans_on else {})
