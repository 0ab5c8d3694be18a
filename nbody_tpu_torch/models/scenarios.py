"""Scenario builders: each returns a (System, GravityConfig) pair.

Port of ``nbody_tpu.models.scenarios``, in the same units. The random
builders take an explicit ``torch.Generator`` and ``device``, as
``state.random_system`` does (they draw on the generator's device and move
the result to ``device``); the deterministic ones take ``device`` and
``dtype``. torch cannot reproduce ``jax.random``'s streams, so the random
scenarios match the JAX package's in distribution, not draw for draw.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import GravityConfig
from ..state import System, _uniform, plummer_system, random_system


def uniform_random(n: int, dim: int = 3, *, generator: torch.Generator,
                   device, dtype: torch.dtype = torch.float32
                   ) -> Tuple[System, GravityConfig]:
    """The reference's benchmark distribution (utils.h:113-115):
    pos ~ U[1, 1e7], vel ~ U[-10, 10], mass ~ U[1, 1e8], G = 4.471e-21."""
    return (random_system(n, dim, generator=generator, device=device,
                          dtype=dtype), GravityConfig())


def plummer_sphere(n: int, dim: int = 3, *, generator: torch.Generator,
                   device, dtype: torch.dtype = torch.float32
                   ) -> Tuple[System, GravityConfig]:
    """Plummer model in Hénon units (G = M = 1, E = −1/4); cold start."""
    s = plummer_system(n, dim, generator=generator, device=device,
                       dtype=dtype, total_mass=1.0, scale_radius=1.0)
    return s, GravityConfig(G=1.0, softening=4.0 / n)


def two_body_circular_orbit(device, dtype: torch.dtype = torch.float64
                            ) -> Tuple[System, GravityConfig]:
    """Equal-mass binary on a circular orbit (G=1, M=1 each, separation 2).

    Circular speed of each body about the barycenter: v² = G·M/(4·r) with
    r = 1 → v = 0.5. Period T = 2π·r/v = 4π. The analytic orbit makes this
    the integrator-accuracy scenario.
    """
    def t(rows):
        return torch.tensor(rows, dtype=dtype, device=device)

    return (System(positions=t([[-1.0, 0.0], [1.0, 0.0]]),
                   velocities=t([[0.0, -0.5], [0.0, 0.5]]),
                   masses=t([1.0, 1.0])),
            GravityConfig(G=1.0, softening=0.0))


def spiral_galaxy(n: int, *, generator: torch.Generator, device,
                  dtype: torch.dtype = torch.float32
                  ) -> Tuple[System, GravityConfig]:
    """2D exponential disk with a central mass and circular rotation (G=1).

    A rotating-disk scenario for visual demos and angular-momentum tests:
    the central body holds 80% of the mass; disk bodies start on locally
    circular orbits about the enclosed mass. Drawn and computed in float64,
    then cast to ``dtype``.
    """
    f64 = torch.float64
    m_central = 0.8
    m_disk = (1.0 - m_central) / (n - 1)
    u = _uniform((n - 1,), 0.02, 0.98, generator, f64)
    r = -torch.log(1.0 - u)  # exponential profile, scale length 1
    phi = _uniform((n - 1,), 0.0, 2.0 * math.pi, generator, f64)
    # Enclosed mass approximation: central + disk fraction within r.
    m_enc = m_central + (n - 1) * m_disk * (1 - torch.exp(-r) * (1 + r))
    v_circ = torch.sqrt(m_enc / r.clamp(min=1e-3))
    zero = torch.zeros((1, 2), dtype=f64, device=r.device)
    pos = torch.cat([zero, torch.stack([r * torch.cos(phi),
                                        r * torch.sin(phi)], -1)])
    vel = torch.cat([zero, torch.stack([-v_circ * torch.sin(phi),
                                        v_circ * torch.cos(phi)], -1)])
    mass = torch.cat([torch.tensor([m_central], dtype=f64, device=r.device),
                      torch.full((n - 1,), m_disk, dtype=f64,
                                 device=r.device)])
    s = System(positions=pos.to(dtype), velocities=vel.to(dtype),
               masses=mass.to(dtype))
    return s.to(device), GravityConfig(G=1.0, softening=0.05)


# J2000-ish heliocentric elements, circular-orbit approximation.
# Units: AU, solar masses, years → G = 4π².
_PLANETS = [
    # name, a [AU], mass [Msun]
    ("Mercury", 0.387, 1.66e-7),
    ("Venus", 0.723, 2.45e-6),
    ("Earth", 1.000, 3.00e-6),
    ("Mars", 1.524, 3.23e-7),
    ("Jupiter", 5.203, 9.55e-4),
    ("Saturn", 9.537, 2.86e-4),
    ("Uranus", 19.191, 4.37e-5),
    ("Neptune", 30.069, 5.15e-5),
]


def solar_system(device, dtype: torch.dtype = torch.float64
                 ) -> Tuple[System, GravityConfig]:
    """Sun + 8 planets on circular coplanar orbits; AU / Msun / yr units
    (G = 4π², so Earth's period is 1.0 by construction). The JAX package
    warns when float64 would be downcast with its x64 mode off; torch has
    float64 always, so there is nothing to warn about."""
    g = 4.0 * math.pi ** 2
    rows_p, rows_v, rows_m = [[0.0, 0.0, 0.0]], [[0.0, 0.0, 0.0]], [1.0]
    for i, (_, a, m) in enumerate(_PLANETS):
        phi = 2.0 * math.pi * i / len(_PLANETS)  # spread phases
        v = math.sqrt(g / a)
        rows_p.append([a * math.cos(phi), a * math.sin(phi), 0.0])
        rows_v.append([-v * math.sin(phi), v * math.cos(phi), 0.0])
        rows_m.append(m)
    s = System(positions=torch.tensor(rows_p, dtype=dtype, device=device),
               velocities=torch.tensor(rows_v, dtype=dtype, device=device),
               masses=torch.tensor(rows_m, dtype=dtype, device=device))
    return s, GravityConfig(G=g, softening=0.0)
