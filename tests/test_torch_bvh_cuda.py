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


@pytest.mark.cuda
def test_spans_on_the_card_time_by_events(cuda_device):
    """With spans on, each BVH phase records a pair of CUDA events that are
    resolved only when the totals are read; the forces stay bit for bit
    those of a run with spans off."""
    from nbody_tpu_torch.utils import profiling
    rng = np.random.default_rng(3)
    nc = 1800
    pos = np.concatenate([0.5 + 1e-3 * rng.uniform(0, 1, (nc, 3)),
                          rng.uniform(0, 1, (2000 - nc, 3))])
    pos = torch.from_numpy(pos).to(cuda_device)
    mass = torch.ones(2000, dtype=torch.float64, device=cuda_device)
    cfg = GravityConfig(G=1.0, softening=1e-4)
    kw = dict(theta=0.5, group_size=32, frontier_width=16, near_cap=16,
              max_escalations=8)
    profiling.reset_spans()
    try:
        off = bvh.bvh_forces(pos, mass, cfg, **kw)
        profiling.enable_spans()
        on = bvh.bvh_forces(pos, mass, cfg, **kw)
        # Queued, not yet read: no span has waited for the card.
        assert profiling._PENDING
        assert profiling._SPAN_TOTALS["bvh.build"][0] == 0
        totals = profiling.span_totals()
        assert not profiling._PENDING
        assert torch.equal(on, off)
        assert {"bvh.build", "bvh.frontier", "bvh.near",
                "bvh.rewalk"} <= set(totals)
        assert all(s > 0 for s, _ in totals.values())
        assert profiling.counter_totals()["bvh.escalations"] \
            == totals["bvh.rewalk"][1]
    finally:
        profiling.reset_spans()
