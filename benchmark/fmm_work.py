"""The FMM's useful M2L work, for ``m2l_roofline``.

M2L transfers each source cell's multipole weights to each target cell of
its V-list, at every level from 2 to the leaf level L: the cells of the
parent's near ring (offsets of at most k = 1 cell a dimension) that are not
in the target's own near ring, inside the grid. Each such pair is a
product of an [n^D, n^D] operator with n^D weights, 2·(n^D)² operations.
Pairs that fall outside the grid, or that a cell's parity excludes, are no
useful work, whatever a program multiplies by zero.

Counted here from ``dim``, N and the order alone, without the program:
the leaf level is a frozen copy of the port's ``auto_leaf_level`` rule,
so that a later change of the program cannot change the yardstick. The
count factors by dimension: in one dimension a cell x of parity q = x mod
2 takes offsets δ with |⌊(q + δ)/2⌋| ≤ 1 and 0 ≤ x + δ < 2^l, and the
V-list pairs of a level are those of the whole ring less those of the near
ring, A^D − B^D, with A and B the one-dimensional sums over x.

The peak is 67e12 operations a second (``benchmark.roofline.FP32_PEAK``):
NVIDIA's data sheet gives that rate for float32 on the CUDA cores and for
float64 on the tensor cores of one H100 SXM, so the share reads the same
whichever route M2L's products take.
"""

from __future__ import annotations

import math

from benchmark.roofline import FP32_PEAK

RING = 1


def leaf_level(n: int, dim: int) -> int:
    """The port's ``auto_leaf_level(n, dim)`` at ring 1, frozen: leaves of
    ~64 bodies in 2D and ~32 in 3D, at most 2^26 / 2^24 leaf cells."""
    occupancy = 64 if dim == 2 else 32
    level = max(1, math.floor(math.log2(max(n, 2) / occupancy) / dim))
    return min(level, {2: 13, 3: 8}[dim])


def _line_sums(level: int) -> tuple:
    """(A, B): over the 2^level cells of a line, the in-grid offsets of the
    parent's near ring, and of the cell's own near ring."""
    side = 1 << level
    whole = near = 0
    for x in range(side):
        for d in range(-(2 * RING + 1), 2 * RING + 2):
            if not 0 <= x + d < side:
                continue
            if abs(math.floor((x % 2 + d) / 2)) <= RING:
                whole += 1
                near += abs(d) <= RING
    return whole, near


def v_list_pairs(dim: int, level: int) -> int:
    """(target, source) cell pairs of the V-lists at one level."""
    whole, near = _line_sums(level)
    return whole ** dim - near ** dim


def m2l_ops(n: int, dim: int, order: int) -> float:
    """M2L's useful operations over levels 2..L for N bodies."""
    nodes = order ** dim
    return sum(2.0 * v_list_pairs(dim, l) * nodes * nodes
               for l in range(2, leaf_level(n, dim) + 1))


def m2l_least_s(n: int, dim: int, order: int) -> float:
    """The least time of one evaluation's M2L at the card's peak."""
    return m2l_ops(n, dim, order) / FP32_PEAK
