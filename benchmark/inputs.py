"""The bodies a cell runs on, drawn from ``--seed`` on the cell's device.

Frozen copies of the port's two recipes (``state.random_system`` and
``state.plummer_system``), so that a later change to the program cannot
change the inputs it is measured on. The configuration file gives every
parameter. Three or four large draws from one ``torch.Generator`` on the
device, in the configuration's dtype: the same seed gives the same bodies on
the same kind of device.
"""

from __future__ import annotations

from typing import Tuple

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _uniform(shape, lo, hi, gen, dtype):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return u * (hi - lo) + lo


def uniform_bodies(n: int, dim: int, spec: dict, gen, dtype):
    """``generate_random_bodies<D>`` (the reference's ``utils.h:108-135``):
    every coordinate, velocity component and mass uniform in its range."""
    pos = _uniform((n, dim), *spec["position_range"], gen, dtype)
    vel = _uniform((n, dim), *spec["velocity_range"], gen, dtype)
    mass = _uniform((n,), *spec["mass_range"], gen, dtype)
    return pos, vel, mass


def plummer_bodies(n: int, dim: int, spec: dict, gen, dtype):
    """A Plummer sphere by the inverse of its cumulative mass profile
    (Aarseth, Henon & Wielen 1974), isotropic directions, equal masses,
    zero velocities (a cold start)."""
    u = _uniform((n,), *spec["u_range"], gen, torch.float32)
    r = spec["scale_radius"] / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)
    direction = torch.randn((n, dim), generator=gen, dtype=torch.float32,
                            device=gen.device)
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    pos = (r[:, None] * direction).to(dtype)
    vel = torch.zeros((n, dim), dtype=dtype, device=gen.device)
    mass = torch.full((n,), spec["total_mass"] / n, dtype=dtype,
                      device=gen.device)
    return pos, vel, mass


RECIPES = {"uniform": uniform_bodies, "plummer": plummer_bodies}


def make_bodies(config: dict, seed: int, device,
                n: int | None = None) -> Tuple[torch.Tensor, ...]:
    """(positions [N, D], velocities [N, D], masses [N]) on ``device``.

    By default the seed draws the bodies. Where the configuration's
    ``bodies`` give a ``set_seed``, that draws them, and the seed draws the
    order they are handed over in: every seed then brings the same work
    (a tree's cost depends on the bodies, not on their order). ``n``
    replaces the configuration's N (the CPU tests' small runs)."""
    device = torch.device(device)
    bodies = config["bodies"]
    n = n or config["n"]
    fixed = bodies.get("set_seed")
    gen = torch.Generator(device=device).manual_seed(
        int(seed if fixed is None else fixed))
    out = RECIPES[bodies["kind"]](n, config["dim"], bodies, gen,
                                  DTYPES[config["dtype"]])
    if fixed is None:
        return out
    gen = torch.Generator(device=device).manual_seed(int(seed))
    order = torch.randperm(n, generator=gen, device=device)
    return tuple(t[order] for t in out)


def sample_rows(n: int, rows: int, seed: int) -> torch.Tensor:
    """The rows the check compares: ``rows`` distinct bodies drawn from the
    seed on the CPU (every body where N ≤ rows), in increasing order."""
    if rows >= n:
        return torch.arange(n)
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=gen)[:rows].sort().values
