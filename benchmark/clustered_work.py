"""The work of the FMM's occupied-cell layout (the port's ``"adaptive"``
layout), for ``near_roofline`` and ``m2l_occupied_roofline``.

The readers take the pairs from the program's own counters, summed on the
device at each force call of the window (``fmm.near_pairs``: each leaf's
bodies times the bodies of its ring's leaves, itself included;
``fmm.m2l_pairs``: M2L's (target cell, offset) pairs whose source cell
holds bodies): the bodies move in a window, and the Plummer cell's cold
core collapses inside it, so a count from the bodies as drawn is not the
work that was timed. This module gives each pair's operations:

* the near field's one-sided pair (the target's sum only), in the
  convention of ``roofline.ONE_SIDED_PAIR_OPS``, 5·D + 6 operations: D
  differences, the squared distance (2·D), the sum into the target (2·D),
  and six for the softening's add, the reciprocal square root, its cube
  and the mass (K2's 16 in 2D; 21 in 3D), at the float32 rate of the CUDA
  cores, ``roofline.FP32_PEAK``;
* M2L's pair, an [n^D, n^D] operator times n^D weights, 2·(n^D)²
  operations at order n (``fmm_work``'s count), at the same 67e12 a
  second, which NVIDIA gives for float64 on the tensor cores too.

It also counts the near pairs from the bodies alone, under frozen copies
of the port's rules, which the tests hold the program's counter to:

* the grid: the bodies' box (AABB) widened ×1.01 about its centre, cut
  into 2^l cells a dimension at level l (``keys.quantize``);
* the depth rule: L is the shallowest level whose fullest cell holds at
  most 256 bodies, the Morton keys' last level (10 in 3D, 16 in 2D) if
  none does (the port also stops at leaves of 128 softening lengths,
  which the Plummer cell's ε = 4/N never reaches: its leaves at L = 10
  span ~4,000 of them).
"""

from __future__ import annotations

import itertools

import torch

from benchmark.roofline import FP32_PEAK

RING = 1
LEAF_MAX = 256
KEY_BITS = {2: 16, 3: 10}


def pair_ops(dim: int) -> int:
    """Operations of one one-sided pair evaluation."""
    return 5 * dim + 6


def _cells(positions: torch.Tensor, level: int) -> torch.Tensor:
    """Integer cell coordinates [N, D] of the bodies at ``level``."""
    dt = positions.dtype
    mins = positions.min(dim=0).values
    maxs = positions.max(dim=0).values
    center = 0.5 * (mins + maxs)
    half = (0.5 * (maxs - mins) * torch.tensor(1.01, dtype=dt)
            + torch.tensor(1e-30, dtype=dt))
    lo, hi = center - half, center + half
    q = torch.floor((positions - lo) * (float(2 ** level) / (hi - lo)))
    return q.to(torch.int64).clamp(0, (1 << level) - 1)


def _occupancy(positions: torch.Tensor, level: int):
    """(occupied cells' coordinates [C, D], their bodies [C])."""
    return torch.unique(_cells(positions, level), dim=0, return_counts=True)


def leaf_level(positions: torch.Tensor) -> int:
    """The frozen depth rule."""
    dim = positions.shape[1]
    for level in range(1, KEY_BITS[dim] + 1):
        if int(_occupancy(positions, level)[1].max()) <= LEAF_MAX:
            return level
    return KEY_BITS[dim]


def near_pairs(positions: torch.Tensor, level: int | None = None) -> int:
    """The near field's real (target, source) pairs at ``level`` (by
    default the depth rule's): over occupied leaves, its bodies times the
    bodies of the in-grid cells within RING of it, itself included."""
    dim = positions.shape[1]
    level = leaf_level(positions) if level is None else level
    cells, counts = _occupancy(positions, level)
    side = 1 << level
    # A cell's key: its coordinates in base 2^level, first slowest.
    weights = torch.tensor([side ** (dim - 1 - d) for d in range(dim)],
                           device=cells.device)
    keys = (cells * weights).sum(1)
    order = torch.argsort(keys)
    keys, counts = keys[order], counts[order]
    cells = cells[order]
    ring = torch.zeros_like(counts)
    for off in itertools.product(range(-RING, RING + 1), repeat=dim):
        nb = cells + torch.tensor(off, device=cells.device)
        inside = ((nb >= 0) & (nb < side)).all(1)
        key = (nb.clamp(0, side - 1) * weights).sum(1)
        row = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
        ring += torch.where(inside & (keys[row] == key), counts[row], 0)
    return int((counts * ring).sum())


def near_least_s(pairs: int, dim: int) -> float:
    """The least time of ``pairs`` evaluations at the card's peak."""
    return pairs * pair_ops(dim) / FP32_PEAK


def m2l_pair_ops(dim: int, order: int) -> int:
    """Operations of one M2L pair at ``order``."""
    nodes = order ** dim
    return 2 * nodes * nodes


def m2l_least_s(pairs: float, dim: int, order: int) -> float:
    """The least time of ``pairs`` M2L pairs at the card's peak."""
    return pairs * m2l_pair_ops(dim, order) / FP32_PEAK
