"""Time integrators: explicit Euler and kick-drift-kick leapfrog.

Port of ``nbody_tpu.integrators``. Steps are plain functions
``(System, forces_fn, dt) -> System``; :func:`simulate` is a Python loop
where the JAX package has ``lax.scan``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .state import System

# forces_fn(positions [N,D], masses [N]) -> forces [N,D]
ForcesFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def euler_step(system: System, forces_fn: ForcesFn, dt) -> System:
    """Explicit Euler: v += F/m·dt; x += v·dt (methods.cpp:426-450 parity)."""
    forces = forces_fn(system.positions, system.masses)
    new_v = system.velocities + forces / system.masses[:, None] * dt
    new_x = system.positions + new_v * dt
    return system.replace(positions=new_x, velocities=new_v)


def leapfrog_step(system: System, forces_fn: ForcesFn, dt) -> System:
    """Symplectic kick-drift-kick leapfrog, two force evaluations."""
    half = dt * 0.5
    a0 = forces_fn(system.positions, system.masses) / system.masses[:, None]
    v_half = system.velocities + a0 * half
    x1 = system.positions + v_half * dt
    a1 = forces_fn(x1, system.masses) / system.masses[:, None]
    v1 = v_half + a1 * half
    return system.replace(positions=x1, velocities=v1)


def leapfrog_step_carried(system: System, acc: torch.Tensor,
                          forces_fn: ForcesFn,
                          dt) -> Tuple[System, torch.Tensor]:
    """One KDK step given the CURRENT acceleration; returns the next state
    and the acceleration at the new positions (one force evaluation).

    Seed with ``acc = forces_fn(x0, m) / m[:, None]``.
    """
    half = dt * 0.5
    v_half = system.velocities + acc * half
    x1 = system.positions + v_half * dt
    a1 = forces_fn(x1, system.masses) / system.masses[:, None]
    v1 = v_half + a1 * half
    return system.replace(positions=x1, velocities=v1), a1


def simulate(system: System, forces_fn: ForcesFn, dt, num_steps: int,
             integrator: str = "leapfrog") -> Tuple[System, None]:
    """Run ``num_steps`` steps; returns ``(final, None)`` like the JAX API.

    The leapfrog path carries the acceleration between steps
    (:func:`leapfrog_step_carried`): one force evaluation per step, the
    same trajectory as chained :func:`leapfrog_step`.
    """
    if integrator == "leapfrog":
        acc = forces_fn(system.positions, system.masses) \
            / system.masses[:, None]
        for _ in range(num_steps):
            system, acc = leapfrog_step_carried(system, acc, forces_fn, dt)
        return system, None
    step = {"euler": euler_step}[integrator]
    for _ in range(num_steps):
        system = step(system, forces_fn, dt)
    return system, None
