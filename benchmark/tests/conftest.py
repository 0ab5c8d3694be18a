"""The benchmark's own CPU tests (``python -m pytest benchmark/tests``).

Tests marked ``cuda`` need a card and skip without one; they decide in a
fixture. Torch is held to two threads, as the port's CPU test modules are.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)

CELLS = ["uniform2d_1m.bh_leapfrog", "plummer3d_1e5.bvh_leapfrog",
         "uniform2d_1m.brute_leapfrog", "uniform2d_5m.ring_leapfrog"]
# Bodies of the CPU runs: small enough for the plain paths, large enough
# for every tier's tree.
SMALL_N = 2000
SEED = 2**31 + 77


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size on the card")
    return torch.device("cuda", 0)
