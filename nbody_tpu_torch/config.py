"""Physical and algorithmic configuration (PyTorch port).

Same fields, names and values as ``nbody_tpu.config`` — the reference
suite's globals (``utils.h:21-27``) and FMM macros (``methods.h:25-27``) as
frozen dataclasses. ``softening`` is used and ``theta`` is honoured, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses

# Physical constants — parity with utils.h:21-27.
G_DEFAULT = 4.471e-21  # Gravitational constant for AU / Earth-mass units.
BARNES_HUT_THETA = 0.25  # utils.h:22.
EPSILON = 1e-11  # utils.h:23 — guard against division by zero.
SOFTENING = 1e-6  # utils.h:24 — Plummer softening length.
ACCURACY_PCT_THRESHOLD = 0.01  # utils.h:25 — 1% per-component threshold.
ACCURACY_FORCE_THRESHOLD = 1e-20  # utils.h:26 — near-zero reference cutoff.
ACCURACY_ABS_THRESHOLD = 1e-9  # utils.h:193 — absolute check for tiny forces.
MASS_THRESHOLD = 1e-10  # utils.h:27.

# FMM defaults — parity with methods.h:25-27.
FMM_ORDER = 8
FMM_MAX_BODIES_PER_LEAF = 100
FMM_MAX_LEVEL = 32

# Initializer distributions — parity with utils.h:113-115.
POSITION_RANGE = (1.0, 1.0e7)
VELOCITY_RANGE = (-10.0, 10.0)
MASS_RANGE = (1.0, 1.0e8)


@dataclasses.dataclass(frozen=True)
class GravityConfig:
    """Softened Newtonian gravity parameters."""

    G: float = G_DEFAULT
    softening: float = SOFTENING
    epsilon: float = EPSILON
    theta: float = BARNES_HUT_THETA

    def replace(self, **kwargs) -> "GravityConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_GRAVITY = GravityConfig()


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Shared spatial-tree parameters (Barnes-Hut / BVH / FMM tiers)."""

    max_bodies_per_leaf: int = 16  # BVH default, methods.h:57.
    max_level: int = FMM_MAX_LEVEL
    order: int = FMM_ORDER

    def replace(self, **kwargs) -> "TreeConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_TREE = TreeConfig()
