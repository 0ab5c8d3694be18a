"""nbody_tpu_torch — the PyTorch / CUDA port of nbody_tpu, for NVIDIA Hopper.

The brute-force tier end to end: struct-of-arrays ``System`` state in 2D/3D,
softened Newtonian gravity, the plain torch oracle and five hand-written
CUDA kernels (``ops/cuda_brute.py``), space-filling-curve keys
(``ops/keys.py``), Euler and leapfrog stepping, the ``Simulation`` API with
npz checkpoints, and the benchmark harness and CLI. The Barnes-Hut grid
tier (``ops/grid_tree.py`` with ``ops/hier_far.py`` and
``ops/local_expansion.py``) runs its leaf near field on a sixth kernel
(``ops/cuda_p2p.py``), and so does the black-box FMM tier (``ops/fmm.py``);
clustered inputs go to the sparse grid (``ops/sparse_grid.py``) under
``layout="auto"``. ``tools/microbench.py`` probes the card's rates.
The JAX package ``nbody_tpu`` is the reference each part is held against.
"""

from .config import (
    DEFAULT_GRAVITY,
    DEFAULT_TREE,
    GravityConfig,
    TreeConfig,
)
from .state import System, plummer_system, random_system, system_from_numpy
from .integrators import euler_step, leapfrog_step, simulate
from .ops.brute_force import (
    brute_force_accelerations,
    brute_force_blocked,
    brute_force_direct,
    kinetic_energy,
    potential_energy,
)
from .ops.grid_tree import barnes_hut_grid
from .simulation import Simulation, available_methods
from .utils.accuracy import (
    accuracy_percentage,
    max_relative_error,
    percentile_relative_error,
    scale_normalized_error,
)

__version__ = "0.1.0"
