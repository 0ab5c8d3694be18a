"""The control, the reference in bfloat16 put in the program's place, fails
every cell's limits: on the CPU at a small N here, and on the card at the
cell's own size (``cuda``)."""

import pytest

from benchmark import catalog, check
from benchmark.control import control_numbers

from conftest import CELLS, SEED, SMALL_N


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell):
    numbers = control_numbers(cell, SEED, "cpu", n=SMALL_N)
    limits = catalog.load("workloads", cell)["check"]["limits"]
    ok, checks = check.judge(numbers, limits)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_size(cell, cuda_device):
    limits = catalog.load("workloads", cell)["check"]["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        ok, checks = check.judge(control_numbers(cell, seed, cuda_device),
                                 limits)
        assert not ok, checks
