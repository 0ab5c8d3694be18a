"""The FMM tier on the card (nbody_tpu_torch.ops.fmm with K6).

Every test here is marked ``cuda`` and skips without a card; the file needs
no JAX (``python -m pytest --noconftest -m cuda tests/test_torch_fmm_cuda.py``
on the card). Tolerance: the fp32 run against the f64 run of the same
bodies within 1e-4 scale-normalized at 2e4 2D (leaf level 4), where the
fp32 far field reads ~1e-5 and K6's near field ~1e-5 (chip_smoke.py [14]
derives the floors).
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import fmm
from nbody_tpu_torch.utils import cuda_build
from nbody_tpu_torch.utils.accuracy import scale_normalized_error


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K6 is built by nvcc and runs only "
                    "on the card")
    return torch.device("cuda", 0)


def _bodies(n, dim, device):
    rng = np.random.default_rng(9)
    return (torch.from_numpy(rng.uniform(1.0, 1e7, (n, dim))).float()
            .to(device),
            torch.from_numpy(rng.uniform(1.0, 1e8, n)).float().to(device))


@pytest.mark.cuda
def test_fmm_refuses_tf32(cuda_device):
    pos, mass = _bodies(2000, 2, cuda_device)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            fmm.fmm_forces(pos, mass, order=8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


@pytest.mark.cuda
def test_fmm_dense_launches_k6_once(cuda_device):
    pos, mass = _bodies(20_000, 2, cuda_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    before = cuda_build.LAUNCHES["near_field"]
    got = fmm.fmm_forces(pos, mass, order=8)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["near_field"] == before + 1
    f64 = fmm.fmm_forces(pos.double(), mass.double(), order=8)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["near_field"] == before + 1
    assert float(scale_normalized_error(got.double(), f64)) < 1e-4
    sparse = fmm.fmm_forces(pos, mass, order=8, layout="sparse")
    assert cuda_build.LAUNCHES["near_field"] == before + 1
    assert float(scale_normalized_error(sparse.double(), f64)) < 1e-4
