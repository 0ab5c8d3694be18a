"""High-level Simulation API: method selection + stepping + diagnostics.

Port of ``nbody_tpu.simulation``:

    sim = Simulation.create(system, config, method="brute")
    sim = sim.run(steps=100, dt=1e-3)
    print(sim.energy())
    sim.save("ckpts")                                   # npz
    sim2 = Simulation.load("ckpts", config, device="cuda")

``"brute"`` resolves by the system's device: CUDA tensors go to the K2
kernel (``brute_force_cuda``, mode ``"precise"``), CPU tensors to the plain
``brute_force_blocked``, as the JAX package does off-TPU. ``"barnes_hut"``
is the grid tree (``ops/grid_tree.barnes_hut_grid``) at the configuration's
θ, ``"fmm"`` the black-box FMM (``ops/fmm.fmm_forces``) at
``min(tree.order, 8)``; the near field of both runs the K6 kernel for fp32
CUDA tensors on the dense layout. ``"bvh"`` is not ported yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from .config import DEFAULT_GRAVITY, DEFAULT_TREE, GravityConfig, TreeConfig
from .integrators import euler_step, leapfrog_step
from .ops.brute_force import kinetic_energy, potential_energy
from .state import System

# Methods of nbody_tpu.simulation that wait for a later slice of the port.
_UNPORTED = {
    "bvh": "ROADMAP queue 1 item 11 (BVH)",
}


def _brute(gravity: GravityConfig, tree: TreeConfig, device: torch.device):
    if device.type == "cuda":
        from .ops.cuda_brute import brute_force_cuda
        return functools.partial(brute_force_cuda, config=gravity,
                                 mode="precise")
    if device.type == "cpu":
        from .ops.brute_force import brute_force_blocked
        return functools.partial(brute_force_blocked, config=gravity)
    raise ValueError(f"unsupported device type {device.type!r} (cpu or cuda)")


def _bh(gravity: GravityConfig, tree: TreeConfig, device: torch.device):
    from .ops.grid_tree import barnes_hut_grid
    return functools.partial(barnes_hut_grid, config=gravity,
                             theta=gravity.theta)


def _fmm(gravity: GravityConfig, tree: TreeConfig, device: torch.device):
    from .ops.fmm import fmm_forces
    return functools.partial(fmm_forces, config=gravity,
                             order=min(tree.order, 8))


# method name -> forces(positions, masses) builder
_FORCE_BUILDERS = {"brute": _brute, "barnes_hut": _bh, "fmm": _fmm}


def available_methods():
    return sorted(_FORCE_BUILDERS)


@dataclasses.dataclass(frozen=True)
class Simulation:
    """Immutable simulation handle; ``run`` returns an advanced copy."""

    system: System
    gravity: GravityConfig
    tree: TreeConfig
    method: str
    integrator: str
    step_count: int
    forces_fn: Callable = dataclasses.field(repr=False, compare=False)

    @classmethod
    def create(cls, system: System,
               gravity: GravityConfig = DEFAULT_GRAVITY,
               tree: TreeConfig = DEFAULT_TREE,
               method: str = "brute",
               integrator: str = "leapfrog") -> "Simulation":
        if method in _UNPORTED:
            raise NotImplementedError(
                f"method {method!r} is not ported to PyTorch yet: "
                f"{_UNPORTED[method]}")
        if method not in _FORCE_BUILDERS:
            raise ValueError(
                f"unknown method {method!r}; available: {available_methods()}")
        if integrator not in ("euler", "leapfrog"):
            raise ValueError(f"unknown integrator {integrator!r}")
        forces_fn = _FORCE_BUILDERS[method](gravity, tree, system.device)
        return cls(system=system, gravity=gravity, tree=tree, method=method,
                   integrator=integrator, step_count=0, forces_fn=forces_fn)

    def forces(self) -> torch.Tensor:
        return self.forces_fn(self.system.positions, self.system.masses)

    def run(self, steps: int, dt: float) -> "Simulation":
        # Two force evaluations per leapfrog step, as nbody_tpu.simulation.
        step = euler_step if self.integrator == "euler" else leapfrog_step
        sys = self.system
        for _ in range(steps):
            sys = step(sys, self.forces_fn, dt)
        return dataclasses.replace(self, system=sys,
                                   step_count=self.step_count + steps)

    def energy(self) -> dict:
        ke = float(kinetic_energy(self.system.velocities, self.system.masses))
        pe = float(potential_energy(self.system.positions, self.system.masses,
                                    self.gravity))
        return {"kinetic": ke, "potential": pe, "total": ke + pe}

    def save(self, directory: str) -> str:
        from . import checkpoint as C
        return C.save_checkpoint(directory, self.system, self.step_count)

    @classmethod
    def load(cls, directory: str,
             gravity: GravityConfig = DEFAULT_GRAVITY,
             tree: TreeConfig = DEFAULT_TREE,
             method: str = "brute",
             integrator: str = "leapfrog",
             step: Optional[int] = None,
             *, device) -> "Simulation":
        from . import checkpoint as C
        system, step_count, _ = C.load_checkpoint(directory, step,
                                                  device=device)
        sim = cls.create(system, gravity, tree, method, integrator)
        return dataclasses.replace(sim, step_count=step_count)
