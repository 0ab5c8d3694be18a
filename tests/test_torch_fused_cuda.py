"""K4 itself on the card (csrc/fused_steps.cu, through
nbody_tpu_torch.ops.cuda_brute.fused_smalln_simulate).

Every test here is marked ``cuda`` and skips without a card; the file needs
no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_fused_cuda.py`` on the card). The kernel's walk and sums
are emulated on the CPU in ``tests/test_torch_fused_smalln.py``.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import cuda_brute as cb
from nbody_tpu_torch.utils import cuda_build
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

# Both sides run the same fp32 operations a step and differ only in the
# order of each force sum; over 16 steps of dt 1e-3 in G = 1 units that
# keeps velocities within the kernels' force tolerance (scale-normalized)
# and positions within 1e-5 of the largest coordinate, as chip_smoke.py
# [9] holds them.
V_TOL, X_TOL = 1e-4, 1e-5
UNIT = {"g": 1.0, "softening": 0.1, "dt": 1e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 is built by nvcc and runs only "
                    "on the card")
    return torch.device("cuda", 0)


def _cluster(n, dim, seed, device):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, dim)).astype(np.float32)
    vel = (0.3 * rng.normal(size=(n, dim))).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    return [torch.from_numpy(a).to(device) for a in (pos, vel, mass)]


@pytest.mark.cuda
def test_cluster_size_is_one_of_the_two(cuda_device):
    assert cb.fused_cluster_size() in (8, 16)


@pytest.mark.cuda
def test_a_second_library_instance_sets_up_its_own_kernels(cuda_device,
                                                            tmp_path):
    """A second copy of the kernel library in one process picks its own
    cluster size and launches K4 with the first copy's bits: its host side
    shares no state with the first (a shared template static once left its
    kernels without their attributes: CUDA error 912)."""
    first = cuda_build.load_library()
    copy = tmp_path / "second.so"
    shutil.copy(cuda_build.library_path(), copy)
    second = ctypes.CDLL(str(copy))
    for name, (argtypes, restype) in cuda_build._SIGNATURES.items():
        getattr(second, name).argtypes = argtypes
        getattr(second, name).restype = restype
    c = ctypes.c_int(0)
    assert second.nbody_fused_cluster_size(ctypes.byref(c)) == 0
    assert c.value == cb.fused_cluster_size()
    x, v, m = _cluster(2048, 3, seed=5, device=cuda_device)
    want = cb.fused_smalln_simulate(x, v, m, num_steps=4, **UNIT)
    pm, vel = cb._pack4(x, m), cb._pack4(v)
    code = second.nbody_fused_steps(
        pm.data_ptr(), vel.data_ptr(), 2048, 3, 4, UNIT["dt"], UNIT["g"],
        UNIT["softening"] ** 2, 0, 0, cb._stream())
    torch.cuda.synchronize()
    assert code == 0, first.nbody_error_string(code).decode()
    assert torch.equal(pm[:, :3], want[0]) and torch.equal(vel[:, :3],
                                                           want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("n,dim", [(1000, 2), (2048, 3), (33, 2)])
def test_portable_cluster_of_8_matches_plain(cuda_device, n, dim,
                                             integrator):
    """The portable size through the wrapper, as a card that places no
    cluster of 16 runs it (R = 2 at 2048): against the plain version,
    bit-identical run to run and K steps against K one-step launches."""
    state = _cluster(n, dim, seed=11 + n, device=cuda_device)
    kw = {"integrator": integrator, **UNIT}
    cb.set_fused_cluster_size(8)
    try:
        assert cb.fused_cluster_size() == 8
        one = cb.fused_smalln_simulate(*state, num_steps=8, **kw)
        two = cb.fused_smalln_simulate(*state, num_steps=8, **kw)
        x, v, m = state
        for _ in range(8):
            x, v = cb.fused_smalln_simulate(x, v, m, num_steps=1, **kw)
    finally:
        cb.set_fused_cluster_size(0)
    assert cb.fused_cluster_size() in (8, 16)
    for a, b, c in zip(one, two, (x, v)):
        assert torch.equal(a, b) and torch.equal(a, c)
    x_ref, v_ref = cb.fused_smalln_plain(*state, num_steps=8, **kw)
    assert float(scale_normalized_error(one[1].double(),
                                        v_ref.double())) < V_TOL
    assert float((one[0] - x_ref).abs().max() / x_ref.abs().max()) < X_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("n,dim", [(1, 2), (33, 3), (1000, 2), (1025, 3),
                                   (2047, 2), (2048, 3)])
def test_kernel_matches_plain_at_ragged_n(cuda_device, n, dim, integrator):
    state = _cluster(n, dim, seed=n, device=cuda_device)
    before = cuda_build.LAUNCHES["fused_steps"]
    x, v = cb.fused_smalln_simulate(*state, num_steps=16,
                                    integrator=integrator, **UNIT)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["fused_steps"] == before + 1
    x_ref, v_ref = cb.fused_smalln_plain(*state, num_steps=16,
                                         integrator=integrator, **UNIT)
    assert bool(torch.isfinite(x).all() and torch.isfinite(v).all())
    assert float(scale_normalized_error(v.double(), v_ref.double())) < V_TOL
    assert float((x - x_ref).abs().max() / x_ref.abs().max()) < X_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("n,dim", [(1000, 2), (2048, 3), (77, 3)])
def test_runs_are_bit_identical_and_k_steps_are_k_single_steps(
        cuda_device, n, dim, integrator):
    """No atomics: two runs give the same bits. K steps in one launch give
    the bits of K launches of one step each, which for leapfrog holds the
    carried force to the force the next launch computes afresh."""
    state = _cluster(n, dim, seed=7 + n, device=cuda_device)
    kw = {"integrator": integrator, **UNIT}
    one = cb.fused_smalln_simulate(*state, num_steps=8, **kw)
    two = cb.fused_smalln_simulate(*state, num_steps=8, **kw)
    x, v, m = state
    for _ in range(8):
        x, v = cb.fused_smalln_simulate(x, v, m, num_steps=1, **kw)
    for a, b, c in zip(one, two, (x, v)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_softening_zero_guard_keeps_coincident_bodies_finite(cuda_device):
    x, v, m = _cluster(700, 2, seed=3, device=cuda_device)
    x[1] = x[0]
    x[650] = x[10]  # a pair in two CTAs' slices
    kw = {"g": 1.0, "softening": 0.0, "dt": 1e-4, "num_steps": 4}
    for integrator in ("euler", "leapfrog"):
        have = cb.fused_smalln_simulate(x, v, m, integrator=integrator, **kw)
        want = cb.fused_smalln_plain(x, v, m, integrator=integrator, **kw)
        for h, w in zip(have, want):
            assert bool(torch.isfinite(h).all())
            assert float(scale_normalized_error(h.double(),
                                                w.double())) < V_TOL
