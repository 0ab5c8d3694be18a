"""Initial-condition models / scenario presets (port of
``nbody_tpu.models``).

The reference generates only one distribution, uniform random positions,
velocities and masses (``utils.h:108-135``). This package keeps that as the
benchmark default and adds physically meaningful families used by the
property tests and demos.
"""

from .scenarios import (
    plummer_sphere,
    solar_system,
    spiral_galaxy,
    two_body_circular_orbit,
    uniform_random,
)

__all__ = [
    "uniform_random",
    "plummer_sphere",
    "two_body_circular_orbit",
    "spiral_galaxy",
    "solar_system",
]
