"""``benchmark.reference`` on hand-worked two- and three-body cases, fp64,
and the arithmetic of ``benchmark.check``."""

import math

import pytest
import torch

from benchmark import check, reference

F64 = torch.float64


def _t(x):
    return torch.tensor(x, dtype=F64)


def test_two_bodies_unsoftened():
    pos, m = _t([[0.0, 0.0], [3.0, 4.0]]), _t([2.0, 5.0])
    f = reference.forces_on_rows(pos, m, torch.arange(2), G=1.0, softening=0)
    # G m0 m1 d / |d|^3 = 10 (3, 4) / 125, and the reaction.
    want = _t([[0.24, 0.32], [-0.24, -0.32]])
    assert torch.allclose(f, want, rtol=1e-15, atol=0)


def test_two_bodies_softened_and_scaled_by_G():
    pos, m = _t([[0.0, 0.0, 0.0], [0.0, 0.0, 2.0]]), _t([1.0, 3.0])
    f = reference.forces_on_rows(pos, m, torch.tensor([0]), G=0.5,
                                 softening=1.0)
    # 0.5 * 1 * 3 * 2 / (4 + 1)^1.5
    assert f[0, 2].item() == pytest.approx(3.0 / 5.0 ** 1.5, rel=1e-15)
    assert f[0, :2].abs().max().item() == 0.0


def test_three_bodies():
    pos, m = _t([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]]), _t([1.0, 2.0, 3.0])
    f = reference.forces_on_rows(pos, m, torch.arange(3), G=1.0, softening=0)
    s5 = 5.0 ** 1.5
    want = _t([
        [2.0 * 1.0 + 0.0, 3.0 * 2.0 / 8.0],                  # 1·(2(1,0)/1 + 3(0,2)/8)
        [2.0 * (-1.0 + 3.0 * -1.0 / s5), 2.0 * 3.0 * 2.0 / s5],  # 2·((−1,0) + 3(−1,2)/5^1.5)
        [3.0 * (2.0 * 1.0 / s5), 3.0 * (-2.0 / 8.0 + 2.0 * -2.0 / s5)],
    ])
    assert torch.allclose(f, want, rtol=1e-14, atol=0)
    assert torch.allclose(f.sum(0), torch.zeros(2, dtype=F64), atol=1e-14)


def test_rows_in_blocks_match_one_block():
    gen = torch.Generator().manual_seed(3)
    pos = torch.rand((300, 3), generator=gen, dtype=F64)
    m = torch.rand(300, generator=gen, dtype=F64)
    rows = torch.tensor([0, 7, 150, 299])
    whole = reference.forces_on_rows(pos, m, rows, 1.0, 0.01)
    blocked = reference.forces_on_rows(pos, m, rows, 1.0, 0.01,
                                       block_elems=300)
    assert torch.equal(whole, blocked)


def test_leapfrog_rows_two_bodies():
    x0, v0 = _t([[0.0, 0.0], [3.0, 4.0]]), _t([[1.0, 0.0], [0.0, -1.0]])
    m = _t([2.0, 5.0])
    dt = 0.1
    x1_all = _t([[0.1, 0.0], [3.0, 3.9]])
    out = reference.leapfrog_rows(x0, v0, m, x1_all, torch.arange(2), dt,
                                  G=1.0, softening=0.0)
    a0 = _t([[0.24, 0.32], [-0.24, -0.32]]) / m[:, None]
    x1 = x0 + (v0 + a0 * dt / 2) * dt
    d = x1_all[1] - x1_all[0]
    f1 = 10.0 * d / d.norm() ** 3
    a1 = torch.stack([f1 / 2.0, -f1 / 5.0])
    assert torch.allclose(out["x1"], x1, rtol=1e-15, atol=1e-16)
    assert torch.allclose(out["v1"], v0 + (a0 + a1) * dt / 2, rtol=1e-14)
    assert torch.allclose(out["forces1"], torch.stack([f1, -f1]), rtol=1e-14)


def test_energy_of_two_bodies():
    pos, m = _t([[0.0, 0.0], [3.0, 4.0]]), _t([2.0, 5.0])
    assert reference.potential_energy(pos, m, 1.0, 0.0) == pytest.approx(-2.0)
    assert reference.kinetic_energy(_t([[1.0, 0.0], [0.0, 2.0]]), m) == 11.0


def test_ulp32():
    assert check.ulp32(_t([1.0, 1.5, 2.0, 1e7])).tolist() == [
        2.0 ** -23, 2.0 ** -23, 2.0 ** -22, 1.0]


def test_numbers_read_zero_on_equal_inputs_and_inf_on_nan():
    f = _t([[1.0, 2.0], [3.0, -1.0]])
    assert check.force_err(f, f) == 0.0
    bad = f.clone()
    bad[0, 0] = math.nan
    assert check.force_err(bad, f) == math.inf
    zero = torch.zeros_like(f)
    assert check.pos_err(bad, f, zero, 0.1) == math.inf
    # A coordinate off by one of its own ulps; one near the origin, by ulps
    # of a thousandth of the RMS radius; with an acceleration, in units of
    # the ulp plus the median drift dt²/2 · |a|.
    x = _t([[1.0, 0.5], [2.0, 0.0]])
    x0 = torch.zeros_like(x)
    assert check.pos_err(x + _t([[0.0, 2.0 ** -24], [0.0, 0.0]]), x, x0,
                         0.1) == 1.0
    floor = 1e-3 * math.sqrt((1.25 + 4.0) / 2)
    tiny = check.ulp32(_t(floor)).item()
    assert check.pos_err(x + _t([[0.0, 0.0], [0.0, 3 * tiny]]), x, x0,
                         0.1) == 3.0
    acc = _t([[3.0, 4.0], [0.0, 5.0]])  # |a| = 5: drift 0.5 * 0.01 * 5
    off = 0.025 + 2.0 ** -23
    assert check.pos_err(x + _t([[off, 0.0], [0.0, 0.0]]), x, acc,
                         0.1) == pytest.approx(1.0, rel=1e-12)


def test_vel_err_in_units_of_the_kick():
    v0 = _t([[1.0, 0.0], [0.0, 1.0]])
    ref = v0 + _t([[0.5, 0.0], [0.0, 0.5]])  # RMS kick 0.5
    got = ref + _t([[0.05, 0.0], [0.0, 0.0]])
    want = 0.05 / (2.0 ** -23 + 0.5)
    assert check.vel_err(got, ref, v0) == pytest.approx(want, rel=1e-12)


def test_judge_and_worst():
    a = {"force_err": 1e-6, "pos_err": 0.5, "vel_err": 0.0}
    b = {"force_err": 2e-6, "pos_err": 0.25, "vel_err": 3.0}
    w = check.worst([a, b])
    assert w == {"force_err": 2e-6, "pos_err": 0.5, "vel_err": 3.0}
    ok, checks = check.judge(w, {"force_err": 1e-5, "pos_err": 1.0,
                                 "vel_err": 2.0})
    assert not ok and checks["vel_err"] == {"value": 3.0, "limit": 2.0}
    assert check.judge(a, {"force_err": 1e-5, "pos_err": 1.0,
                           "vel_err": 2.0})[0]
