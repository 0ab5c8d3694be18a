"""The rate probe P (nbody_tpu_torch.tools.microbench): its plain versions
against the same loop bodies in jnp (``lax.fori_loop``, as in
tools/vpu_microbench.py) at tiny sizes.

The probe kernels themselves run only on the card: ``chip_smoke.py`` [13]
and the ``cuda``-marked test below, which skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu_torch.tools import microbench as mb
from nbody_tpu_torch.utils import cuda_build

# The TPU tool's loop bodies (tools/vpu_microbench.py:64-88), with the
# reciprocal times the kernel's runtime c = 1 (csrc/rate_probe.cu).
_JAX_BODIES = {
    "f32 mul": lambda x: x * mb.C32,
    "f32 fma": lambda x: x * mb.C32 + mb.D32,
    "f32 add": lambda x: x + mb.D32,
    "f32 rsqrt": jax.lax.rsqrt,
    "f32 rsqrt+cube (u*u*u)": lambda x: (lambda u: u * u * u)(
        jax.lax.rsqrt(x)),
    "f32 reciprocal(approx)": lambda x: (1.0 / x) * 1.0,
    "f32 where(x<c, 0, x)": lambda x: jnp.where(x < 0.5, 0.0, x) + mb.D32,
    "bf16 mul": lambda x: x * mb.C16,
    "bf16 fma": lambda x: x * mb.C16 + mb.D16,
    "bf16 rsqrt via f32": lambda x: jax.lax.rsqrt(
        x.astype(jnp.float32)).astype(x.dtype),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe kernels are built by nvcc "
                    "and run only on the card")
    return torch.device("cuda", 0)


def _block(seed, dtype):
    x = 0.5 + np.random.default_rng(seed).uniform(0, 1, (8, 16))
    return x.astype(np.float32), torch.from_numpy(x.astype(np.float32)).to(
        dtype)


@pytest.mark.parametrize("op", mb.OPS, ids=lambda op: op.name)
def test_probe_plain_matches_jax_loop(op):
    iters = 4
    xn, xt = _block(op.code, op.dtype)
    jdt = jnp.bfloat16 if op.dtype == torch.bfloat16 else jnp.float32
    body = _JAX_BODIES[op.name]
    want = jax.lax.fori_loop(0, iters, lambda _, x: body(x),
                             jnp.asarray(xn).astype(jdt))
    have = mb.rate_probe(op, xt, iters)
    assert have.dtype == op.dtype and have.shape == xt.shape
    want = np.asarray(want.astype(jnp.float32))
    # f32: a few ulps after a few iterations (the fma rounds once here, as
    # fmaf does; XLA may round twice), except x ↦ x^-1.5, which multiplies
    # a relative error by 1.5 each iteration. bf16: one ulp, 2^-8.
    tol = (2.0 ** -8 if op.dtype == torch.bfloat16 else
           1e-5 if op.code == 4 else 1e-6)
    np.testing.assert_allclose(have.float().numpy(), want, rtol=tol)


def test_matmul_probe_plain_matches_jax_loop():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (16, 64)).astype(np.float32)
    b = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    want = jax.lax.fori_loop(
        0, 3, lambda _, acc: acc + jnp.dot(
            jnp.asarray(a), jnp.asarray(b),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32),
        jnp.zeros((16, 4), jnp.float32))
    have = mb.matmul_probe(torch.from_numpy(a), torch.from_numpy(b), 3)
    np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-6)


def test_probe_ops_mirror_the_kernel():
    """Op codes 0-9 in kernel order, one per TPU probe; the CPU path
    launches nothing."""
    assert [op.code for op in mb.OPS] == list(range(10))
    assert len(mb.OPS_BY_NAME) == len(mb.OPS) == len(_JAX_BODIES)
    before = dict(cuda_build.LAUNCHES)
    mb.rate_probe(mb.OPS[0], torch.ones(4), 2)
    mb.matmul_probe(torch.ones(2, 3), torch.ones(3, 2), 2)
    assert cuda_build.LAUNCHES == before
    with pytest.raises(ValueError, match="takes"):
        mb.rate_probe(mb.OPS_BY_NAME["bf16 mul"], torch.ones(4), 2)
    with pytest.raises(ValueError, match="matmul_probe"):
        mb.matmul_probe(torch.ones(2, 3), torch.ones(4, 2), 1)


def test_probe_needs_a_card(monkeypatch, capsys):
    with pytest.raises(ValueError, match="CUDA device"):
        mb.run(iters=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mb.main(["--iters", "2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card(cuda_device):
    for op in mb.OPS:
        _, xt = _block(op.code, op.dtype)
        x = xt.to(cuda_device)
        got = mb.rate_probe(op, x, 5).float().cpu()
        want = mb.rate_probe_plain(op, x, 5).float().cpu()
        tol = 2.0 ** -8 if op.dtype == torch.bfloat16 else 4e-6
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol)
