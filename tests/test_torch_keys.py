"""Space-filling-curve keys of the port (nbody_tpu_torch.ops.keys) against
the JAX package's, bit for bit, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import keys as JK
from nbody_tpu_torch.ops import keys as TK


def _positions(n, dim, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 1e7, size=(n, dim)).astype(np.float32)
    pos[:4] = pos[4]  # ties: equal keys, order decided by the stable sort
    return pos


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("bits", [None, 3, 7])
def test_keys_bit_identical_to_jax(dim, bits):
    pos = _positions(700, dim, seed=dim * 10 + (bits or 0))
    b = bits or JK.MAX_BITS[dim]
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    np.testing.assert_array_equal(
        TK.quantize(tp, b).numpy(), np.asarray(JK.quantize(jp, b)))
    for name in ("morton_key", "hilbert_key"):
        want = np.asarray(getattr(JK, name)(jp, bits)).astype(np.int64)
        have = getattr(TK, name)(tp, bits)
        assert have.dtype == torch.int64
        np.testing.assert_array_equal(have.numpy(), want, err_msg=name)
        assert int(have.min()) >= 0 and int(have.max()) < 1 << 32


@pytest.mark.parametrize("bits,dim", [(2, 2), (3, 3), (16, 2), (10, 3)])
def test_keys_from_coords_match_jax(bits, dim):
    rng = np.random.default_rng(bits)
    coords = rng.integers(0, 1 << bits, size=(300, dim)).astype(np.uint32)
    for name in ("morton_key_from_coords", "hilbert_key_from_coords"):
        want = np.asarray(getattr(JK, name)(jnp.asarray(coords), bits))
        have = getattr(TK, name)(torch.from_numpy(coords.astype(np.int64)),
                                 bits)
        np.testing.assert_array_equal(have.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dim", [2, 3])
def test_sort_order_identical_to_jax(dim):
    pos = _positions(500, dim, seed=dim)
    vel = np.random.default_rng(1).normal(size=pos.shape).astype(np.float32)
    mass = np.arange(500, dtype=np.float32)
    jk = JK.morton_key(jnp.asarray(pos))
    want = JK.sort_bodies_by_key(jk, jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(mass))
    tk = TK.morton_key(torch.from_numpy(pos))
    have = TK.sort_bodies_by_key(tk, torch.from_numpy(pos),
                                 torch.from_numpy(vel),
                                 torch.from_numpy(mass))
    for h, w in zip(have, want):
        np.testing.assert_array_equal(h.numpy(), np.asarray(w).astype(
            h.numpy().dtype))
    assert have[3] is not None
    assert TK.sort_bodies_by_key(tk, torch.from_numpy(pos), None,
                                 torch.from_numpy(mass))[3] is None
