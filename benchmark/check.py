"""The numbers that decide ``correct``: the program's forces and state against
the reference's (:mod:`benchmark.reference`) on the sampled rows.

* ``force_err``: the largest ‖F − F_ref‖ over the rows, over the RMS of
  ‖F_ref‖ (scale-normalized), worst over the checked force calls. A checked
  step that made no force call reads infinity.
* ``pos_err``: the largest error of a coordinate of x1, over one float32
  ulp of that coordinate (of a thousandth of the rows' RMS radius where the
  coordinate is smaller) plus the median drift that the acceleration alone
  makes in a step, dt²/2 · median ‖a_ref‖. Rounding reads under 1 and a
  force error its share of the median acceleration; a step that leaves the
  positions as they were reads tens or more (in the reference's units a
  drift of 0.1 is below an ulp at 1e7, so only coordinates near the origin
  show it).
* ``vel_err``: the largest ‖v1 − v1_ref‖_∞ of a row, over one float32 ulp
  of the row's velocity plus the RMS kick ‖v1_ref − v0‖ of the rows: where
  the kick is below an ulp (the reference's own units), rounding reads under
  1; where it is not, the error of the kick itself.

Non-finite values read infinity. Each number has its limit in the cell's
file (``workloads/<cell>.json``), set from the readings ``PERF.md`` gives.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NUMBERS = ("force_err", "pos_err", "vel_err")
_TINY32 = 2.0 ** -126


def ulp32(x: torch.Tensor) -> torch.Tensor:
    """The float32 ulp of |x| (its exponent less 23), floored at the smallest
    normal."""
    e = torch.floor(torch.log2(x.abs().to(torch.float64).clamp(min=_TINY32)))
    return torch.exp2(e - 23)


def _finite_or_inf(value: torch.Tensor, *tensors) -> float:
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        return math.inf
    return float(value)


def force_err(forces: torch.Tensor, ref: torch.Tensor) -> float:
    f, r = forces.to(torch.float64), ref.to(torch.float64)
    num = torch.linalg.norm(f - r, dim=-1).max()
    scale = torch.sqrt(torch.mean(torch.sum(r * r, dim=-1)))
    return _finite_or_inf(num / scale.clamp(min=_TINY32), f)


def pos_err(x1: torch.Tensor, x1_ref: torch.Tensor, acc_ref: torch.Tensor,
            dt: float) -> float:
    x, r = x1.to(torch.float64), x1_ref.to(torch.float64)
    floor = 1e-3 * torch.sqrt(torch.mean(torch.sum(r * r, dim=-1)))
    drift = 0.5 * dt * dt * torch.linalg.norm(acc_ref.to(torch.float64),
                                              dim=-1).median()
    scale = ulp32(torch.maximum(r.abs(), floor)) + drift
    return _finite_or_inf(((x - r).abs() / scale).max(), x)


def vel_err(v1: torch.Tensor, v1_ref: torch.Tensor, v0: torch.Tensor) -> float:
    v, r = v1.to(torch.float64), v1_ref.to(torch.float64)
    kick = torch.sqrt(torch.mean(torch.sum((r - v0.to(torch.float64)) ** 2,
                                           dim=-1)))
    err = (v - r).abs().amax(dim=-1)
    return _finite_or_inf((err / (ulp32(r.abs().amax(dim=-1)) + kick)).max(),
                          v)


def step_numbers(forces: List[Tuple[torch.Tensor, torch.Tensor]],
                 x1: torch.Tensor, v1: torch.Tensor,
                 ref: Dict[str, torch.Tensor], dt: float) -> Dict[str, float]:
    """The three numbers of one checked step. ``forces``: (the program's
    forces on the rows, the reference's at the same positions), one pair a
    force call; ``x1``, ``v1``: the program's state on the rows after the
    step; ``ref``: :func:`benchmark.reference.leapfrog_rows`."""
    return {
        "force_err": max((force_err(f, r) for f, r in forces),
                         default=math.inf),
        "pos_err": pos_err(x1, ref["x1"], ref["acc0"], dt),
        "vel_err": vel_err(v1, ref["v1"], ref["v0"]),
    }


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over the checked steps."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): correct where every number is
    finite and at most its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
