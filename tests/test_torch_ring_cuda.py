"""The ring brute force on the card (nbody_tpu_torch.parallel.ring on CUDA
tensors, a mesh of virtual shards of one card).

Every test here is marked ``cuda`` and skips without a card; the file needs
no JAX (``python -m pytest --noconftest -m cuda tests/test_torch_ring_cuda.py``
on the card). The engines follow the bodies: fp32 CUDA tensors run K2
(``local_accel_cuda``) and K3 (``sym_accel_cuda``), counted in
``cuda_build.LAUNCHES``; f64 CUDA tensors run the plain rows, no launch.
Tolerances: fp32 against the f64 sum, the scale-normalized 1e-4 of the
kernels' own checks; f64 card against f64 CPU, 1e-12 of the largest force.
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import GravityConfig
from nbody_tpu_torch.ops import cuda_brute as cb
from nbody_tpu_torch.parallel import mesh as pm
from nbody_tpu_torch.parallel import ring
from nbody_tpu_torch.utils.accuracy import scale_normalized_error
from nbody_tpu_torch.utils.cuda_build import LAUNCHES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this is the ring on CUDA tensors "
                    "through the kernels K2 and K3")
    return torch.device("cuda", 0)


def _bodies(n, dim, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, dim), generator=gen, dtype=torch.float64)
    mass = 0.5 + torch.rand((n,), generator=gen, dtype=torch.float64)
    return pos.to(dev, dtype), mass.to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("p,k3", [(3, 3), (4, 8)])
def test_fp32_ring_runs_k2_and_k3(cuda_device, p, k3):
    pos, mass = _bodies(3000, 3, torch.float32, cuda_device)
    cfg = GravityConfig(G=1.0, softening=1e-3)
    local, sym = ring._engines(pos, None, None)
    assert local is cb.local_accel_cuda and sym is cb.sym_accel_cuda
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    got = ring.ring_brute_force(pos, mass, cfg,
                                mesh=pm.make_mesh([cuda_device] * p))
    torch.cuda.synchronize()
    assert LAUNCHES["precise"] == p and LAUNCHES["sym_tile"] == k3
    assert LAUNCHES["symmetric"] == 0
    want = (cfg.G * mass.double())[:, None] * cb.pairwise_accel_plain(
        pos.double(), pos.double(), mass.double(), cfg.softening)
    assert float(scale_normalized_error(got.double(), want)) < 1e-4


@pytest.mark.cuda
def test_f64_ring_on_the_card_equals_the_cpu(cuda_device):
    pos, mass = _bodies(1000, 2, torch.float64, cuda_device, seed=1)
    local, sym = ring._engines(pos, None, None)
    assert local is ring.plain_local_accel and sym is ring.plain_sym_accel
    cfg = GravityConfig(G=1.0, softening=1e-3)
    dev = ring.ring_brute_force(pos, mass, cfg,
                                mesh=pm.make_mesh([cuda_device] * 4))
    cpu = ring.ring_brute_force(pos.cpu(), mass.cpu(), cfg,
                                mesh=pm.make_mesh([torch.device("cpu")] * 4))
    want = cpu.numpy()
    np.testing.assert_allclose(dev.cpu().numpy(), want, rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))
