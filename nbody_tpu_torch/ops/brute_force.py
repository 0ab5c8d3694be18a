"""Brute-force O(N²) gravitational forces in plain PyTorch.

Port of ``nbody_tpu.ops.brute_force``. Same force convention, attractive
with Plummer softening ε, and the reference's ``d² < 1e-10`` pair-skip guard
(``methods.cpp:24``), always on in these plain paths:

    F_i = G · m_i · Σ_{j≠i}  m_j · (x_j − x_i) / (‖x_j − x_i‖² + ε²)^{3/2}

Works dimension by dimension so only (T, S) tiles are materialized, never a
(T, S, D) tensor: the same dataflow as the CUDA kernels in ``cuda_brute``.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_GRAVITY, GravityConfig

# Reference pair-skip guard: dist² < 1e-10 → no interaction (methods.cpp:24).
_DIST2_GUARD = 1e-10
# Zero-mass padding bodies sit far away (brute_force.py / pallas_brute.py).
_PAD_POS = 2.0e9


def _diffs_d2(targets, sources):
    """Per-dimension [T, S] differences x_s − x_t and their squared sum."""
    diffs = [sources[:, d][None, :] - targets[:, d][:, None]
             for d in range(targets.shape[-1])]
    d2 = diffs[0] * diffs[0]
    for diff in diffs[1:]:
        d2 = d2 + diff * diff
    return diffs, d2


def _guarded_u3(d2, softening, guard=True):
    """(d² + ε²)^{-3/2}, zeroed where d² < the reference guard if ``guard``."""
    inv_r = torch.rsqrt(d2 + float(softening) ** 2)
    u3 = inv_r * inv_r * inv_r
    if not guard:
        return u3
    return torch.where(d2 < _DIST2_GUARD, torch.zeros_like(u3), u3)


def _accel_rows(targets, sources, source_masses, softening, guard=True):
    """Acceleration (force / m_target) on each target from all sources: [T, D].

    ``guard=False`` drops the pair skip, the CUDA kernels' policy at
    softening > 0 (``cuda_brute``); this oracle's own callers keep it.
    """
    diffs, d2 = _diffs_d2(targets, sources)
    w = source_masses[None, :] * _guarded_u3(d2, softening, guard)  # m_j / r³
    return torch.stack([torch.sum(w * diff, dim=1) for diff in diffs], dim=-1)


def _accel_rows_sym(targets, target_masses, sources, source_masses,
                    softening, guard=True):
    """Newton's-3rd-law rectangular tile: both sides from one pair sweep.

    Returns (acc_t [T, D], part_s [S, D]): ``acc_t`` is Σ_s m_s·Δ/r³
    (Δ = x_s − x_t) and ``part_s`` the sources' share −Σ_t m_t·Δ/r³. For
    DISJOINT blocks: no self-pair handling beyond the ``d² < guard`` zeroing.
    """
    diffs, d2 = _diffs_d2(targets, sources)
    u3 = _guarded_u3(d2, softening, guard)
    w_t = source_masses[None, :] * u3
    w_s = target_masses[:, None] * u3
    acc_t = torch.stack([torch.sum(w_t * diff, dim=1) for diff in diffs],
                        dim=-1)
    part_s = torch.stack([-torch.sum(w_s * diff, dim=0) for diff in diffs],
                         dim=-1)
    return acc_t, part_s


def brute_force_accelerations(positions, masses,
                              config: GravityConfig = DEFAULT_GRAVITY):
    """Per-body acceleration a_i = F_i / m_i, full N×N. [N, D]."""
    return config.G * _accel_rows(positions, positions, masses,
                                  config.softening)


def brute_force_direct(positions, masses,
                       config: GravityConfig = DEFAULT_GRAVITY):
    """Per-body forces, full N×N materialization. [N, D]."""
    return masses[:, None] * brute_force_accelerations(positions, masses,
                                                       config)


def brute_force_blocked(positions, masses,
                        config: GravityConfig = DEFAULT_GRAVITY,
                        block_size: int = 1024):
    """Per-body forces with O(block_size · N) memory.

    Each block of target rows scans all sources. N is padded to a multiple
    of ``block_size`` with target rows at a far-away coordinate; the padded
    rows are dropped from the result.
    """
    n, d = positions.shape
    nb = -(-n // block_size)
    pad = nb * block_size - n
    pos_p = torch.cat([positions, positions.new_full((pad, d), _PAD_POS)])
    acc = torch.cat([
        _accel_rows(pos_p[b * block_size:(b + 1) * block_size], positions,
                    masses, config.softening)
        for b in range(nb)])[:n]
    return masses[:, None] * (config.G * acc)


def potential_energy(positions, masses,
                     config: GravityConfig = DEFAULT_GRAVITY):
    """Total softened potential energy U = −G Σ_{i<j} m_i m_j / r_ij (0-d)."""
    diff = positions[None, :, :] - positions[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    inv_r = torch.rsqrt(d2 + float(config.softening) ** 2)
    n = positions.shape[0]
    mask = ~torch.eye(n, dtype=torch.bool, device=positions.device)
    pair = torch.where(mask, masses[:, None] * masses[None, :] * inv_r,
                       torch.zeros_like(inv_r))
    return -0.5 * config.G * torch.sum(pair)


def potential_energy_blocked(positions, masses,
                             config: GravityConfig = DEFAULT_GRAVITY,
                             block_size: int = 1024):
    """:func:`potential_energy` in [B, N] row tiles (scales to N ≥ 1e6).

    Self pairs and padding rows are skipped by index, never by d², so
    coincident distinct bodies count as in the dense version. A tile is
    built and scaled in place, so two [B, N] tensors are live at a time
    (16 GiB at B = 2048, N = 2^20 in fp32; one per dimension and term would
    not fit the card).
    """
    n, dim = positions.shape
    n_pad = -(-n // block_size) * block_size
    pos_p = torch.cat([positions, positions.new_zeros((n_pad - n, dim))])
    m_p = torch.cat([masses, masses.new_zeros((n_pad - n,))])
    soft2 = float(config.softening) ** 2
    total = positions.new_zeros(())
    for i0 in range(0, n_pad, block_size):
        tp = pos_p[i0:i0 + block_size]
        d2 = positions.new_zeros((block_size, n_pad))
        for d in range(dim):
            diff = pos_p[None, :, d] - tp[:, d, None]
            d2.add_(diff.square_())
        del diff
        inv_r = d2.add_(soft2).rsqrt_()
        inv_r[:, n:] = 0.0  # padding sources
        inv_r[max(0, n - i0):] = 0.0  # padding targets
        inv_r[:, i0:i0 + block_size].fill_diagonal_(0.0)  # self pairs
        pair = inv_r.mul_(m_p[i0:i0 + block_size, None] * m_p[None, :])
        total = total + torch.sum(pair)
    return -0.5 * config.G * total


def kinetic_energy(velocities, masses):
    return 0.5 * torch.sum(masses * torch.sum(velocities * velocities,
                                              dim=-1))
