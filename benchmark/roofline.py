"""Operation counts and the card's peaks, for the roofline shares.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense, the
same figures ``chip_smoke.py`` uses. ``FP32_PEAK`` is the float32 rate of the
CUDA cores, outside the tensor cores; ``HBM_RATE`` the HBM3 bandwidth.

Counts: fp32 operations a pair of the softened law, as the port's kernels
evaluate it (``chip_smoke.py``'s bounds): 16 for the one-sided pair in 2D
(K2), 17 and 21 for the Newton-3 pair in 2D and 3D, which also adds the
reaction into the source's sum (K1, K3). Every count assumes the fp32 peak
of the CUDA cores. A later route through the tensor cores does other work
against another peak, and needs its own count, added by a benchmark change.
"""

from __future__ import annotations

FP32_PEAK = 67e12  # float32 operations a second, CUDA cores
HBM_RATE = 3.35e12  # bytes a second

ONE_SIDED_PAIR_OPS = {2: 16}
NEWTON3_PAIR_OPS = {2: 17, 3: 21}


def newton3_ops(n: int, dim: int) -> float:
    """The operations the exact all-pairs sum needs: each of the
    N(N−1)/2 unordered pairs once, at the Newton-3 pair's count."""
    return NEWTON3_PAIR_OPS[dim] * n * (n - 1) / 2


def newton3_least_s(n: int, dim: int, cards: int) -> float:
    """The least time for one exact force evaluation on ``cards`` cards:
    the Newton-3 work over their summed fp32 peak."""
    return newton3_ops(n, dim) / (FP32_PEAK * cards)
