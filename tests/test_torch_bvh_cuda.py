"""The BVH tier on the card (nbody_tpu_torch.ops.bvh on CUDA tensors).

Every test here is marked ``cuda`` and skips without a card; the file needs
no JAX (``python -m pytest --noconftest -m cuda tests/test_torch_bvh_cuda.py``
on the card). Tolerance: the same f64 bodies through the CUDA path and the
CPU path agree to 1e-12 of the largest force, which holds only if CUDA's
sort, gathers and ``index_put_`` change no MAC decision and no escalation.
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import GravityConfig
from nbody_tpu_torch.ops import bvh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this is the BVH walk on CUDA "
                    "tensors")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_cuda_path_equals_cpu_path_in_f64(cuda_device, dim):
    n = 20_000
    gen = torch.Generator().manual_seed(dim)
    pos = torch.rand((n, dim), generator=gen, dtype=torch.float64)
    mass = 0.5 + torch.rand((n,), generator=gen, dtype=torch.float64)
    cfg = GravityConfig(G=1.0, softening=1e-3)
    cpu = bvh.bvh_forces(pos, mass, cfg, theta=0.25)
    dev = bvh.bvh_forces(pos.to(cuda_device), mass.to(cuda_device), cfg,
                         theta=0.25)
    assert dev.device.type == "cuda"
    want = cpu.numpy()
    np.testing.assert_allclose(dev.cpu().numpy(), want, rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))
