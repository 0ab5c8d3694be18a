"""Cross-algorithm accuracy oracle (PyTorch port of
``nbody_tpu.utils.accuracy``).

A body is "accurate" iff every force component is within 1% relative error
of the reference, with near-zero reference components (<1e-20) checked
absolutely against 1e-9 (``utils.h:171-267``). NaN-strict like the JAX
package: a non-finite force is never accurate and makes the normalized
metrics infinite. Inputs may be tensors or numpy arrays; results are 0-d
tensors on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (
    ACCURACY_ABS_THRESHOLD,
    ACCURACY_FORCE_THRESHOLD,
    ACCURACY_PCT_THRESHOLD,
)


def _tensor(x, device=None):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))  # a copy: x may be read-only
    return x if device is None else x.to(device)


def _pair(forces, reference_forces):
    forces = _tensor(forces)
    return forces, _tensor(reference_forces, forces.device)


def _inf_unless_finite(forces, err):
    return torch.where(torch.all(torch.isfinite(forces)), err,
                       torch.full_like(err, float("inf")))


def accuracy_percentage(
    forces,
    reference_forces,
    rel_threshold: float = ACCURACY_PCT_THRESHOLD,
    near_zero: float = ACCURACY_FORCE_THRESHOLD,
    abs_threshold: float = ACCURACY_ABS_THRESHOLD,
):
    """Percentage of bodies whose every component is within tolerance.

    Parity: ``compute_accuracy_omp`` (utils.h:171-219), made NaN-strict.
    """
    forces, reference_forces = _pair(forces, reference_forces)
    if forces.shape != reference_forces.shape:
        raise ValueError(
            f"force shapes differ: {tuple(forces.shape)} vs "
            f"{tuple(reference_forces.shape)}")
    tiny_ref = torch.abs(reference_forces) < near_zero
    rel_err = torch.abs((forces - reference_forces) / reference_forces)
    comp_ok = torch.where(tiny_ref, torch.abs(forces) <= abs_threshold,
                          rel_err <= rel_threshold)
    comp_ok = comp_ok & torch.isfinite(forces)
    body_ok = torch.all(comp_ok, dim=-1)
    out = (torch.float64 if forces.dtype == torch.float64
           else torch.float32)
    return 100.0 * torch.mean(body_ok.to(out))


def scale_normalized_error(forces, reference_forces):
    """max_i ‖F_i − F_i^ref‖ normalized by the RMS reference force magnitude."""
    forces, reference_forces = _pair(forces, reference_forces)
    num = torch.linalg.norm(forces - reference_forces, dim=-1)
    scale = torch.sqrt(torch.mean(
        torch.sum(reference_forces * reference_forces, dim=-1)))
    err = torch.max(num) / torch.clamp(scale, min=torch.finfo(scale.dtype).tiny)
    return _inf_unless_finite(forces, err)


def percentile_relative_error(forces, reference_forces, q: float = 99.0):
    """q-th percentile of per-body relative L2 error ‖ΔF_i‖/‖F_i^ref‖."""
    forces, reference_forces = _pair(forces, reference_forces)
    num = torch.linalg.norm(forces - reference_forces, dim=-1)
    den = torch.linalg.norm(reference_forces, dim=-1)
    err = num / torch.clamp(den, min=torch.finfo(den.dtype).tiny)
    return _inf_unless_finite(forces, torch.quantile(err, q / 100.0))


def max_relative_error(forces, reference_forces):
    """max_i ‖F_i − F_i^ref‖ / ‖F_i^ref‖ — the BASELINE.json ≤1e-4 metric."""
    forces, reference_forces = _pair(forces, reference_forces)
    num = torch.linalg.norm(forces - reference_forces, dim=-1)
    den = torch.linalg.norm(reference_forces, dim=-1)
    err = num / torch.clamp(den, min=torch.finfo(den.dtype).tiny)
    # Non-finite forces are an immediate failure, not a skip.
    err = torch.where(torch.all(torch.isfinite(forces), dim=-1), err,
                      torch.full_like(err, float("inf")))
    return torch.max(err)
