"""Particle state (PyTorch port of ``nbody_tpu.state``).

Struct-of-arrays like the JAX package: ``positions [N, D]``,
``velocities [N, D]``, ``masses [N]``, D in {2, 3}. The device is always
the tensors' own; every constructor takes it explicitly.

``random_system`` and ``plummer_system`` draw the same distributions as the
JAX package (``utils.h:108-135`` ranges; Plummer inverse CDF) from a
``torch.Generator``. They cannot reproduce ``jax.random`` streams, so tests
that compare the two packages build their inputs with numpy and hand them
to both through :func:`system_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .config import MASS_RANGE, POSITION_RANGE, VELOCITY_RANGE


@dataclasses.dataclass(frozen=True)
class System:
    """Struct-of-arrays particle state.

    Attributes:
      positions:  float tensor [N, D], D in {2, 3}.
      velocities: tensor [N, D].
      masses:     tensor [N].
    """

    positions: torch.Tensor
    velocities: torch.Tensor
    masses: torch.Tensor

    @property
    def n(self) -> int:
        return self.positions.shape[0]

    @property
    def dim(self) -> int:
        return self.positions.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.positions.dtype

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def replace(self, **kwargs) -> "System":
        return dataclasses.replace(self, **kwargs)

    def astype(self, dtype: torch.dtype) -> "System":
        return System(positions=self.positions.to(dtype),
                      velocities=self.velocities.to(dtype),
                      masses=self.masses.to(dtype))

    def to(self, device) -> "System":
        return System(positions=self.positions.to(device),
                      velocities=self.velocities.to(device),
                      masses=self.masses.to(device))

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(positions, velocities, masses) as host numpy arrays."""
        return tuple(t.detach().cpu().numpy()
                     for t in (self.positions, self.velocities, self.masses))

    def validate(self) -> None:
        n, d = self.positions.shape
        if d not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {d}")
        if tuple(self.velocities.shape) != (n, d):
            raise ValueError(
                f"velocities shape {tuple(self.velocities.shape)} != {(n, d)}")
        if tuple(self.masses.shape) != (n,):
            raise ValueError(
                f"masses shape {tuple(self.masses.shape)} != {(n,)}")


def system_from_numpy(positions, velocities, masses, device,
                      dtype: Optional[torch.dtype] = None) -> System:
    """Build a System on ``device`` from host arrays (numpy or array-like).

    ``dtype=None`` keeps the arrays' own floating type.
    """
    def conv(a):
        t = torch.as_tensor(np.asarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    return System(positions=conv(positions), velocities=conv(velocities),
                  masses=conv(masses))


def _uniform(shape, lo, hi, generator, dtype):
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return u * (hi - lo) + lo


def random_system(
    n: int,
    dim: int = 3,
    *,
    generator: torch.Generator,
    device,
    dtype: torch.dtype = torch.float32,
    position_range: Tuple[float, float] = POSITION_RANGE,
    velocity_range: Tuple[float, float] = VELOCITY_RANGE,
    mass_range: Tuple[float, float] = MASS_RANGE,
) -> System:
    """Seeded analog of ``generate_random_bodies<D>`` (utils.h:108-135).

    Draws on the generator's device, then moves to ``device``.
    """
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    positions = _uniform((n, dim), *position_range, generator, dtype)
    velocities = _uniform((n, dim), *velocity_range, generator, dtype)
    masses = _uniform((n,), *mass_range, generator, dtype)
    return System(positions=positions, velocities=velocities,
                  masses=masses).to(device)


def plummer_system(
    n: int,
    dim: int = 3,
    *,
    generator: torch.Generator,
    device,
    dtype: torch.dtype = torch.float32,
    total_mass: float = 1.0,
    scale_radius: float = 1.0,
) -> System:
    """Plummer-sphere initial conditions (positions only; cold start)."""
    gdev = generator.device
    u = _uniform((n,), 1e-4, 1.0 - 1e-4, generator, torch.float32)
    # Inverse CDF of the Plummer cumulative mass profile.
    r = scale_radius / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)
    direction = torch.randn((n, dim), generator=generator,
                            dtype=torch.float32, device=gdev)
    direction = direction / torch.linalg.norm(direction, dim=-1,
                                              keepdim=True)
    positions = (r[:, None] * direction).to(dtype)
    velocities = torch.zeros((n, dim), dtype=dtype, device=gdev)
    masses = torch.full((n,), total_mass / n, dtype=dtype, device=gdev)
    return System(positions=positions, velocities=velocities,
                  masses=masses).to(device)
