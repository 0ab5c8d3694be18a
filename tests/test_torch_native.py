"""The port's copy of the native oracle binding (nbody_tpu_torch.utils.
native) against the port's f64 brute force and Hilbert keys. Skipped when
native/libnbody_oracle.so is not built (``make -C native``), as
tests/test_native.py skips."""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import GravityConfig
from nbody_tpu_torch.ops import keys as K
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.state import random_system
from nbody_tpu_torch.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native oracle not built (make -C native)")


def _system(n, dim, dtype):
    return random_system(n, dim, generator=torch.Generator().manual_seed(dim),
                         device="cpu", dtype=dtype)


@pytest.mark.parametrize("dim", [2, 3])
def test_native_forces_match_the_port(dim):
    s = _system(256, dim, torch.float64)
    cfg = GravityConfig()
    want = brute_force_direct(s.positions, s.masses, cfg).numpy()
    got = native.brute_force_native(s.positions.numpy(), s.masses.numpy(),
                                    cfg.G, cfg.softening)
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("dim", [2, 3])
def test_native_hilbert_matches_the_port(dim):
    bits = K.MAX_BITS[dim]
    s = _system(1000, dim, torch.float32)
    coords = K.quantize(s.positions, bits)
    want = K.hilbert_key_from_coords(coords, bits).numpy()
    got = native.hilbert_keys_native(coords.numpy(), bits)
    np.testing.assert_array_equal(got.astype(np.int64), want)
