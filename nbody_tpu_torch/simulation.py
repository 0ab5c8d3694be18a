"""High-level Simulation API: method selection + stepping + diagnostics.

Port of ``nbody_tpu.simulation``:

    sim = Simulation.create(system, config, method="brute")
    sim = sim.run(steps=100, dt=1e-3)
    print(sim.energy())
    sim.save("ckpts")                                   # npz
    sim2 = Simulation.load("ckpts", config, device="cuda")

``"brute"`` resolves by the system's device: CUDA tensors go to
``cuda_brute.brute_force_routed``, the Newton-3 kernel K1 from
``K1_MIN_N`` bodies up and the one-sided K2 below, CPU tensors to the plain
``brute_force_blocked``, as the JAX package does off-TPU. The JAX package
takes its one-sided kernel at every N on the TPU; on the card the results
agree with it within tolerance, not bit for bit (K1 sums in fp64, by
atomics whose order can change from run to run). ``"barnes_hut"``
is the grid tree (``ops/grid_tree.barnes_hut_grid``) at the configuration's
θ, ``"fmm"`` the black-box FMM (``ops/fmm.fmm_forces``) at
``min(tree.order, 8)``; the near field of both runs the K6 kernel for fp32
CUDA tensors on the dense layout. ``"bvh"`` is the Hilbert radix BVH
(``ops/bvh.bvh_forces``) with ``tree.max_bodies_per_leaf`` bodies a leaf,
plain torch on the bodies' device.

``run`` steps by the JAX package's two-evaluation ``leapfrog_step`` and
gets the same results, but not the same number of force calls. The handle
it returns carries its last force evaluation: the inputs (the very tensors
and their in-place version counters), ``forces_fn`` and the forces. A force
call on those same, unmodified tensors with the same ``forces_fn`` returns
the carried forces without calling it. F(x0) of a step is the previous
step's F(x1), made on the same tensor, so a leapfrog step costs one force
call after a fresh handle's first step (two), across ``run`` calls too.
``create`` and ``load`` start with no carry; a handle given another
``system`` or ``forces_fn`` (``dataclasses.replace``), or whose positions or
masses were edited in place, carries nothing that matches. Euler never
evaluates at its new positions, so it keeps one call a step.

With spans on (``utils.profiling.enable_spans``), ``run`` puts each step in
a ``sim.step`` span and each of its force calls in a ``sim.force`` span,
and counts each carried evaluation it hands back under ``sim.carried``.
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
from .utils import profiling

def _brute(gravity: GravityConfig, tree: TreeConfig, device: torch.device):
    if device.type == "cuda":
        from .ops.cuda_brute import brute_force_routed
        return functools.partial(brute_force_routed, config=gravity)
    if device.type == "cpu":
        from .ops.brute_force import brute_force_blocked
        return functools.partial(brute_force_blocked, config=gravity)
    raise ValueError(f"unsupported device type {device.type!r} (cpu or cuda)")


def _bh(gravity: GravityConfig, tree: TreeConfig, device: torch.device):
    from .ops.grid_tree import barnes_hut_grid
    return functools.partial(barnes_hut_grid, config=gravity,
                             theta=gravity.theta)


def _bvh(gravity: GravityConfig, tree: TreeConfig, device: torch.device):
    from .ops.bvh import bvh_forces
    return functools.partial(bvh_forces, config=gravity,
                             leaf_size=tree.max_bodies_per_leaf)


def _fmm(gravity: GravityConfig, tree: TreeConfig, device: torch.device):
    from .ops.fmm import fmm_forces
    return functools.partial(fmm_forces, config=gravity,
                             order=min(tree.order, 8))


# method name -> forces(positions, masses) builder
_FORCE_BUILDERS = {"brute": _brute, "barnes_hut": _bh, "bvh": _bvh,
                   "fmm": _fmm}


def available_methods():
    return sorted(_FORCE_BUILDERS)


@dataclasses.dataclass(frozen=True)
class _Carry:
    """A force evaluation of ``forces_fn`` on ``positions`` and ``masses``
    (these tensor objects, at the in-place ``versions`` they had when it was
    made) and its output ``forces``."""

    positions: torch.Tensor
    masses: torch.Tensor
    versions: tuple
    forces_fn: Callable
    forces: torch.Tensor

    def holds(self, positions, masses, forces_fn) -> bool:
        return (positions is self.positions and masses is self.masses
                and forces_fn is self.forces_fn
                and (positions._version, masses._version) == self.versions)


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
    # The last force evaluation ``run`` made (module docstring).
    carried: Optional[_Carry] = dataclasses.field(default=None, repr=False,
                                                  compare=False)

    @classmethod
    def create(cls, system: System,
               gravity: GravityConfig = DEFAULT_GRAVITY,
               tree: TreeConfig = DEFAULT_TREE,
               method: str = "brute",
               integrator: str = "leapfrog") -> "Simulation":
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
        # The step makes the two force evaluations of nbody_tpu.simulation's
        # leapfrog; one that the carry holds is handed back, not recomputed.
        step = euler_step if self.integrator == "euler" else leapfrog_step
        sys = self.system
        device = sys.positions.device
        spanned = profiling.spanned("sim.force", self.forces_fn, device)
        carry = self.carried

        def forces_fn(positions, masses):
            nonlocal carry
            if carry is not None and carry.holds(positions, masses,
                                                 self.forces_fn):
                profiling.count("sim.carried")
                return carry.forces
            versions = (positions._version, masses._version)
            forces = spanned(positions, masses)
            carry = _Carry(positions, masses, versions, self.forces_fn,
                           forces)
            return forces

        for _ in range(steps):
            with profiling.span("sim.step", device):
                sys = step(sys, forces_fn, dt)
        return dataclasses.replace(self, system=sys,
                                   step_count=self.step_count + steps,
                                   carried=carry)

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
