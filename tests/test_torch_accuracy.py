"""nbody_tpu_torch.utils.accuracy against nbody_tpu.utils.accuracy."""

import numpy as np
import pytest

import nbody_tpu.utils.accuracy as jacc
import nbody_tpu_torch.utils.accuracy as tacc

METRICS = ["accuracy_percentage", "scale_normalized_error",
           "percentile_relative_error", "max_relative_error"]


def _arrays(dtype, nan=False):
    rng = np.random.default_rng(1)
    ref = rng.normal(size=(200, 3))
    ref[::17, 1] = 1e-25  # near-zero reference components
    got = ref * (1 + rng.normal(scale=3e-3, size=ref.shape))
    got[::23] += 1e-8
    if nan:
        got[5, 2] = np.nan
    return got.astype(dtype), ref.astype(dtype)


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_metric_matches_jax(name, dtype):
    got, ref = _arrays(dtype)
    want = float(getattr(jacc, name)(got, ref))
    have = float(getattr(tacc, name)(got, ref))
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(have, want, rtol=rtol)


@pytest.mark.parametrize("name", METRICS)
def test_nan_strict_matches_jax(name):
    got, ref = _arrays(np.float64, nan=True)
    want = float(getattr(jacc, name)(got, ref))
    have = float(getattr(tacc, name)(got, ref))
    assert have == want
    if name != "accuracy_percentage":
        assert have == float("inf")


def test_shape_mismatch_raises_like_jax():
    a, b = np.zeros((4, 3)), np.zeros((4, 2))
    with pytest.raises(ValueError) as jerr:
        jacc.accuracy_percentage(a, b)
    with pytest.raises(ValueError) as terr:
        tacc.accuracy_percentage(a, b)
    assert str(terr.value) == str(jerr.value)
