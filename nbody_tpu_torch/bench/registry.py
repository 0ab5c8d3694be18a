"""Method registry (PyTorch port of ``nbody_tpu.bench.registry``, tiers a,
b and f).

Tier letters match the reference CLI (``main.cpp:885-928``): a = brute
force, b = Barnes-Hut, h = BVH, f = FMM. Tiers a, b and f are ported:

* ``BruteForce_Torch`` — plain blocked torch path (``BruteForce_JNP``);
* ``BruteForce_CUDA`` — the Newton-3 symmetric CUDA kernel K1
  (``BruteForce_Pallas``), for any N that fits on the card;
* ``BarnesHut_Grid`` (θ from the configuration) and
  ``BarnesHut_Grid_Theta05`` — the grid tree, its near field on the K6
  kernel for CUDA tensors, with the JAX package's hyperparameters.
  (``BarnesHut_Sharded`` is multi-device: ROADMAP queue 1 item 12.)
* ``FMM_Chebyshev`` — the black-box FMM at order ``min(order, 8)``, its
  dense near field on K6 for fp32 CUDA tensors.

``cuda_only`` methods run only when the run's device is CUDA.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..config import GravityConfig, TreeConfig

# signature: (positions, masses, gravity_cfg, tree_cfg) -> forces [N, D]
MethodFn = Callable[[torch.Tensor, torch.Tensor, GravityConfig, TreeConfig],
                    torch.Tensor]
# hyper(n, dim, gravity_cfg, tree_cfg) -> the resolved configuration
HyperFn = Callable[[int, int, GravityConfig, TreeConfig], dict]

PORTED_TIERS = "abf"


@dataclasses.dataclass(frozen=True)
class Method:
    name: str
    tier: str  # 'a' | 'b' | 'h' | 'f'
    fn: MethodFn
    cuda_only: bool = False
    hyper: Optional[HyperFn] = None

    def hyperparams(self, n: int, dim: int, cfg: GravityConfig,
                    tree_cfg: TreeConfig) -> dict:
        return self.hyper(n, dim, cfg, tree_cfg) if self.hyper else {}


_REGISTRY: Dict[str, Method] = {}


def register(name: str, tier: str, cuda_only: bool = False,
             hyper: Optional[HyperFn] = None):
    def deco(fn: MethodFn) -> MethodFn:
        _REGISTRY[name] = Method(name=name, tier=tier, fn=fn,
                                 cuda_only=cuda_only, hyper=hyper)
        return fn
    return deco


def get(name: str) -> Method:
    return _REGISTRY[name]


def methods_for_tiers(tiers: str, device):
    """Registered methods whose tier letter is in ``tiers``, for a run on
    ``device``."""
    on_cuda = torch.device(device).type == "cuda"
    return [m for m in _REGISTRY.values()
            if m.tier in tiers and (on_cuda or not m.cuda_only)]


# --- Tier a: brute force -----------------------------------------------------

@register("BruteForce_Torch", "a",
          hyper=lambda n, d, c, t: {"impl": "torch_blocked",
                                    "block_size": 1024})
def _bf_torch(pos, mass, cfg, tree_cfg):
    from ..ops.brute_force import brute_force_blocked
    return brute_force_blocked(pos, mass, cfg, block_size=1024)


@register("BruteForce_CUDA", "a", cuda_only=True,
          hyper=lambda n, d, c, t: {"kernel": "cuda_symmetric"})
def _bf_cuda(pos, mass, cfg, tree_cfg):
    from ..ops.cuda_brute import brute_force_cuda
    return brute_force_cuda(pos, mass, cfg, mode="symmetric")


# --- Tier b: Barnes-Hut ------------------------------------------------------

def _bh_hyper(theta_of):
    def hyper(n, dim, cfg, tree_cfg):
        from ..ops.grid_tree import resolve_bh_params
        p = dict(resolve_bh_params(n, dim, theta_of(cfg)))
        p["layout"] = "auto"
        return p
    return hyper


@register("BarnesHut_Grid", "b", hyper=_bh_hyper(lambda c: c.theta))
def _bh_grid(pos, mass, cfg, tree_cfg):
    from ..ops.grid_tree import barnes_hut_grid
    return barnes_hut_grid(pos, mass, cfg, theta=cfg.theta)


@register("BarnesHut_Grid_Theta05", "b", hyper=_bh_hyper(lambda c: 0.5))
def _bh_grid_05(pos, mass, cfg, tree_cfg):
    from ..ops.grid_tree import barnes_hut_grid
    return barnes_hut_grid(pos, mass, cfg, theta=0.5)


# --- Tier f: FMM -------------------------------------------------------------

def _fmm_hyper(n, dim, cfg, tree_cfg):
    from ..ops.grid_tree import auto_leaf_level
    return {"order": min(tree_cfg.order, 8),
            "leaf_level": auto_leaf_level(n, dim),
            "leaf_batch": 256 if (dim == 3 and n >= 5_000_000) else 1024,
            "layout": "auto"}


@register("FMM_Chebyshev", "f", hyper=_fmm_hyper)
def _fmm_cheb(pos, mass, cfg, tree_cfg):
    from ..ops.fmm import fmm_forces
    return fmm_forces(pos, mass, cfg, order=min(tree_cfg.order, 8))


def reference_method_for(n: int, device) -> Method:
    """Reference-force implementation by N (main.cpp:102-124): the plain
    blocked path, or the CUDA kernel on the card once N amortizes launches."""
    if torch.device(device).type == "cuda" and n >= 32768:
        return get("BruteForce_CUDA")
    return get("BruteForce_Torch")
