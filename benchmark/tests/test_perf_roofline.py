"""The counts and peaks of ``benchmark.roofline``."""

import pytest

from benchmark import roofline


def test_peaks_are_the_data_sheet_figures():
    assert roofline.FP32_PEAK == 67e12
    assert roofline.HBM_RATE == 3.35e12
    assert roofline.ONE_SIDED_PAIR_OPS[2] == 16
    assert roofline.NEWTON3_PAIR_OPS == {2: 17, 3: 21}


@pytest.mark.parametrize("n,dim,cards,ms", [
    (1_000_000, 2, 1, 126.9),   # the brute cell's least time a call
    (5_000_000, 2, 4, 792.9),   # the ring cell's, over four cards (~793)
])
def test_newton3_least_time(n, dim, cards, ms):
    assert roofline.newton3_least_s(n, dim, cards) * 1e3 == pytest.approx(
        ms, abs=0.05)


def test_newton3_ops_counts_unordered_pairs():
    assert roofline.newton3_ops(3, 2) == 17 * 3
    assert roofline.newton3_ops(4, 3) == 21 * 6
