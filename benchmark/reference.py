"""The plain reference: softened Newtonian gravity and a kick-drift-kick
leapfrog step, in plain PyTorch, on a sample of rows.

Independent of the port: it imports nothing of ``nbody_tpu_torch`` and takes
nothing the program made except the positions it is asked to judge. The law
is the configuration's::

    F_i = G · m_i · Σ_{j≠i} m_j · (x_j − x_i) / (‖x_j − x_i‖² + ε²)^{3/2}

The self pair is left out by index; no other pair is skipped. Rows are
computed in blocks of whole source sweeps, so that no temporary passes
``block_elems`` elements a dimension. The dtype is a parameter: float64 for
the reference, bfloat16 for the control (:mod:`benchmark.control`).
"""

from __future__ import annotations

from typing import Dict

import torch

BLOCK_ELEMS = 1 << 25


def forces_on_rows(positions, masses, rows, G: float, softening: float,
                   dtype=torch.float64,
                   block_elems: int = BLOCK_ELEMS) -> torch.Tensor:
    """Forces [R, D] on ``rows`` from every body, computed in ``dtype``."""
    pos = positions.to(dtype)
    m = masses.to(dtype)
    rows = rows.to(pos.device)
    n, dim = pos.shape
    soft2 = float(softening) ** 2
    block = max(1, block_elems // n)
    out = []
    for i in range(0, rows.numel(), block):
        r = rows[i:i + block]
        diffs = [pos[None, :, d] - pos[r, d][:, None] for d in range(dim)]
        d2 = diffs[0] * diffs[0]
        for diff in diffs[1:]:
            d2 = d2 + diff * diff
        w = m[None, :] * (d2 + soft2) ** -1.5
        w[torch.arange(r.numel(), device=w.device), r] = 0  # the self pair
        out.append(torch.stack([(w * diff).sum(dim=1) for diff in diffs],
                               dim=-1))
    acc = torch.cat(out)
    return (G * m[rows])[:, None] * acc


def leapfrog_rows(x0, v0, masses, x1_all, rows, dt: float, G: float,
                  softening: float, dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """One kick-drift-kick step of ``rows`` from the state (x0, v0):

    a0 = F(x0)/m, x1 = x0 + (v0 + a0·dt/2)·dt, a1 = F(x1_all)/m,
    v1 = v0 + a0·dt/2 + a1·dt/2.

    The second force sum runs over ``x1_all``, every body's position after
    the step as the state being judged holds it: the rows' own x1 needs
    only their a0, but their a1 needs every body's x1. Returns the rows'
    ``forces0``, ``acc0``, ``x1``, ``forces1``, ``v1`` and ``v0`` in
    ``dtype``.
    """
    rows = rows.to(x0.device)
    m = masses.to(dtype)[rows][:, None]
    half = dt * 0.5
    f0 = forces_on_rows(x0, masses, rows, G, softening, dtype)
    v_half = v0.to(dtype)[rows] + f0 / m * half
    x1 = x0.to(dtype)[rows] + v_half * dt
    f1 = forces_on_rows(x1_all, masses, rows, G, softening, dtype)
    v1 = v_half + f1 / m * half
    return {"forces0": f0, "acc0": f0 / m, "x1": x1, "forces1": f1,
            "v1": v1, "v0": v0.to(dtype)[rows]}


def potential_energy(positions, masses, G: float, softening: float,
                     block_elems: int = BLOCK_ELEMS) -> float:
    """U = −G Σ_{i<j} m_i m_j / sqrt(r² + ε²) in float64, in row blocks
    (every pair: N² work, for the energy drift printed beside the result)."""
    pos = positions.to(torch.float64)
    m = masses.to(torch.float64)
    n, dim = pos.shape
    soft2 = float(softening) ** 2
    block = max(1, block_elems // n)
    total = 0.0
    for i in range(0, n, block):
        r = torch.arange(i, min(n, i + block), device=pos.device)
        d2 = sum((pos[None, :, d] - pos[r, d][:, None]) ** 2
                 for d in range(dim))
        w = m[None, :] * (d2 + soft2) ** -0.5
        w[torch.arange(r.numel(), device=w.device), r] = 0
        total += float((m[r] * w.sum(dim=1)).sum())
    return -0.5 * G * total


def kinetic_energy(velocities, masses) -> float:
    v = velocities.to(torch.float64)
    return float(0.5 * (masses.to(torch.float64) * (v * v).sum(-1)).sum())
