"""K6's plain versions (nbody_tpu_torch.ops.cuda_p2p) against the JAX
Pallas P2P kernel, run in interpret mode, and the tree's jnp near field:
the window entry (``p2p_leaf_cuda``) and the path's near field
(``near_field_plain``, the tree kernel's plain version).

K6 itself runs only on the card: ``chip_smoke.py`` phases [11]-[12], the
``cuda``-marked test below and those of ``tests/test_torch_near_field.py``,
which skip without one. Here the wrappers get CPU tensors and take their
plain versions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import grid_tree as jax_grid
from nbody_tpu.ops.grid_tree import _point_mass_accel as jax_point_mass
from nbody_tpu.ops.pallas_p2p import p2p_leaf_pallas
from nbody_tpu_torch.ops import cuda_p2p
from nbody_tpu_torch.ops.grid_tree import (_point_mass_accel,
                                           grid_tree_from_numpy)
from nbody_tpu_torch.utils import cuda_build
from nbody_tpu_torch.utils.accuracy import scale_normalized_error


# Several test processes share the machine's cores: a few torch threads
# each keep them from oversubscribing it.
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K6 is built by nvcc and runs only "
                    "on the card")
    return torch.device("cuda", 0)


def _leaf_inputs(nl, c, s, dim, seed):
    """JAX-layout inputs: tpos4 [NL, C, 4], src8 [NL, 8, S] at the
    reference's scale, with each target's twin among the sources (a
    coincident pair) and every fifth source invalid (mass 0)."""
    rng = np.random.default_rng(seed)
    tpos4 = np.zeros((nl, c, 4), np.float32)
    tpos4[..., :dim] = rng.uniform(1.0, 1e7, (nl, c, dim))
    src8 = np.zeros((nl, 8, s), np.float32)
    src8[:, :dim, :] = rng.uniform(1.0, 1e7, (nl, dim, s))
    src8[:, :dim, :c] = np.swapaxes(tpos4[..., :dim], 1, 2)
    src8[:, 3, :] = rng.uniform(1.0, 1e8, (nl, s))
    src8[:, 3, ::5] = 0.0
    return tpos4, src8


def _packed(tpos4, src8, dim):
    """The port's layout: targets [NL, C, D], sources [NL, S, 4]."""
    src4 = np.concatenate([src8[:, :3, :], src8[:, 3:4, :]], axis=1)
    return (torch.from_numpy(tpos4[..., :dim].copy()),
            torch.from_numpy(np.ascontiguousarray(np.swapaxes(src4, 1, 2))))


# The JAX package's own bound for this kernel against its jnp near field
# (tests/test_grid_tree.py:301-311) is 1e-6 on a whole BH evaluation; per
# leaf both sides sum the same fp32 terms in other orders, held to 1e-5.
@pytest.mark.parametrize("softening", [0.0, 1e-6])
@pytest.mark.parametrize("nl,c,s", [(4, 16, 200), (3, 40, 333)])
def test_p2p_plain_matches_pallas(dim, nl, c, s, softening):
    tpos4, src8 = _leaf_inputs(nl, c, s, dim, seed=nl * s + dim)
    want = np.asarray(p2p_leaf_pallas(jnp.asarray(tpos4), jnp.asarray(src8),
                                      dim=dim, softening=softening,
                                      interpret=True))
    have = cuda_p2p.p2p_leaf_plain(torch.from_numpy(tpos4),
                                   torch.from_numpy(src8), dim=dim,
                                   softening=softening)
    assert have.shape == (nl, c, 4) and have.dtype == torch.float32
    assert bool(torch.isfinite(have).all())
    assert not have[..., dim:].any()
    err = float(scale_normalized_error(have[..., :dim].reshape(-1, dim),
                                       want[..., :dim].reshape(-1, dim)))
    assert err < 1e-5, err
    t, s4 = _packed(tpos4, src8, dim)
    np.testing.assert_array_equal(cuda_p2p.p2p_plain(t, s4, softening).numpy(),
                                  have[..., :dim].numpy())


def test_point_mass_guard_always_on_matches_jax():
    """The tree near field zeroes a pair whose raw d² < 1e-10 whatever the
    softening: a coincident pair adds nothing, even at softening > 0."""
    tpos4, src8 = _leaf_inputs(2, 8, 50, 3, seed=5)
    t = tpos4[..., :3].astype(np.float64)
    sp = np.swapaxes(src8[:, :3, :], 1, 2).astype(np.float64)
    sm = src8[:, 3, :].astype(np.float64)
    for soft in (0.0, 0.5):
        want = np.asarray(jax_point_mass(jnp.asarray(t), jnp.asarray(sp),
                                         jnp.asarray(sm), soft))
        have = _point_mass_accel(torch.from_numpy(t), torch.from_numpy(sp),
                                 torch.from_numpy(sm), soft).numpy()
        np.testing.assert_allclose(have, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    # Only the coincident twin, softened: exactly zero.
    lone = _point_mass_accel(torch.zeros((1, 1, 3), dtype=torch.float64),
                             torch.zeros((1, 1, 3), dtype=torch.float64),
                             torch.ones((1, 1), dtype=torch.float64), 0.5)
    assert float(lone.abs().max()) == 0.0


def test_p2p_leaf_cuda_on_cpu_takes_the_plain_version():
    tpos4, src8 = _leaf_inputs(5, 24, 130, 2, seed=9)
    t, s4 = _packed(tpos4, src8, 2)
    before = dict(cuda_build.LAUNCHES)
    have = cuda_p2p.p2p_leaf_cuda(t.double(), s4.double(), softening=1e-6)
    assert cuda_build.LAUNCHES == before
    assert have.dtype == torch.float64
    want = cuda_p2p.p2p_plain(t.double(), s4.double(), 1e-6)
    assert torch.equal(have, want)


def test_p2p_leaf_pack_lays_out_the_kernel_buffers():
    """K6's fp32 buffers: targets as float4 rows with zero columns past D,
    the sources contiguous in fp32, an output of the targets' row shape."""
    tpos4, src8 = _leaf_inputs(3, 10, 40, 2, seed=4)
    t, s4 = _packed(tpos4, src8, 2)
    t4, s4f, out = cuda_p2p.p2p_leaf_pack(t.double(), s4.double())
    assert t4.dtype == s4f.dtype == out.dtype == torch.float32
    assert t4.shape == out.shape == (3, 10, 4) and s4f.is_contiguous()
    assert torch.equal(t4[..., :2], t) and not t4[..., 2:].any()
    assert torch.equal(s4f, s4)


def test_p2p_plain_row_blocks_match_one_pass(monkeypatch):
    """The plain version's row blocking (bounded temporaries) changes no
    value."""
    tpos4, src8 = _leaf_inputs(7, 12, 90, 3, seed=2)
    t, s4 = _packed(tpos4, src8, 3)
    whole = cuda_p2p.p2p_plain(t, s4, 0.0)
    monkeypatch.setattr(cuda_p2p, "_PLAIN_TILE_ELEMS", 12 * 90 * 2)
    assert torch.equal(cuda_p2p.p2p_plain(t, s4, 0.0), whole)


def test_p2p_leaf_cuda_rejects_bad_shapes():
    t = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="targets"):
        cuda_p2p.p2p_leaf_cuda(torch.zeros((2, 4)), torch.zeros((2, 5, 4)),
                               softening=0.0)
    with pytest.raises(ValueError, match="sources"):
        cuda_p2p.p2p_leaf_cuda(t, torch.zeros((2, 5, 3)), softening=0.0)
    with pytest.raises(ValueError, match="sources"):
        cuda_p2p.p2p_leaf_cuda(t, torch.zeros((3, 5, 4)), softening=0.0)


@pytest.mark.cuda
def test_k6_kernel_matches_plain_on_card(cuda_device):
    """K6 itself against its f64 plain version (1e-5 scale-normalized; the
    chip smoke run holds the path's own shapes)."""
    tpos4, src8 = _leaf_inputs(6, 48, 3000, 2, seed=1)
    t, s4 = _packed(tpos4, src8, 2)
    before = cuda_build.LAUNCHES["p2p_leaf"]
    have = cuda_p2p.p2p_leaf_cuda(t.to(cuda_device), s4.to(cuda_device),
                                  softening=1e-6)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["p2p_leaf"] == before + 1
    want = cuda_p2p.p2p_plain(t.double(), s4.double(), 1e-6)
    err = float(scale_normalized_error(have.cpu().double().reshape(-1, 2),
                                       want.reshape(-1, 2)))
    assert err < 1e-5, err


def _carried_tree(n, dim, level, seed):
    """(JAX tree, the same tree carried into the port) over one f64 draw."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 1e7, (n, dim))
    mass = rng.uniform(1.0, 1e8, n)
    mass[::9] = 0.0
    cap = jax_grid.compute_capacity(jnp.asarray(pos), level)
    jtree = jax_grid.build_grid_tree(jnp.asarray(pos), jnp.asarray(mass),
                                     level, cap)
    fields = {f.name: getattr(jtree, f.name)
              for f in dataclasses.fields(jtree)}
    return jtree, grid_tree_from_numpy(
        {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
             else v if isinstance(v, int) else np.asarray(v))
         for k, v in fields.items()}, device="cpu")


# The plain version of K6's tree kernel (the path's near field) against the
# JAX package's near field (its far field skipped), segment by segment, on
# one tree in f64: both sum the same pairs, so only summation order
# separates them.
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_near_field_plain_matches_jax(dim, k, segments):
    n, level = (1500, 4) if dim == 2 else (1200, 2)
    jtree, tree = _carried_tree(n, dim, level, seed=10 * k + dim)
    nl = tree.num_leaf_cells // segments
    for si in range(segments):
        want = np.asarray(jax_grid.grid_tree_accel_sorted(
            jtree, k=k, softening=1e-6, num_segments=segments,
            segment_index=jnp.int32(si), _debug_skip="far"))
        have = cuda_p2p.near_field_plain(tree, k, 1e-6, si * nl, nl)
        assert have.dtype == torch.float64 and np.abs(want).max() > 0
        err = float(scale_normalized_error(have, want))
        assert err < 1e-12, err
