"""Brute-force all-pairs forces through hand-written CUDA kernels (fp32).

Port of the two ``nbody_tpu.ops.pallas_brute`` kernels on the brute-force
main path, each with its plain PyTorch version beside it:

* K2 ``"precise"`` (``_kernel_precise``): one-sided Σ_s m_s·u³·Δ per target,
  ``csrc/precise.cu``; plain version :func:`pairwise_accel_plain`.
* K1 ``"symmetric"`` (``_kernel_symmetric``): Newton-3, each unordered block
  pair swept once, ``csrc/symmetric.cu``; plain version
  :func:`symmetric_forces_plain`, which enumerates the same block pairs.

Dispatch: a wrapper runs the plain version only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises; nothing falls back. Each
launch adds one to ``LAUNCHES[<mode>]``.

Guard policy, as the TPU kernels (``pallas_brute.py:48-60``): the reference
pair skip (d² < 1e-10) is on only when softening == 0 unless ``guard`` says
otherwise. The plain ``brute_force`` oracle always guards.
"""

from __future__ import annotations

import math

import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..utils import cuda_build
from .brute_force import _accel_rows, _accel_rows_sym

#: Kernel launches per mode since the process started (or a caller reset).
LAUNCHES = {"precise": 0, "symmetric": 0}

#: Square block of the symmetric kernel (csrc/symmetric.cu kSymBlock).
SYM_BLOCK = 1024

# Target rows per plain-version step: keeps each [rows, S] temporary at
# 2^27 elements however many sources there are.
_PLAIN_TILE_ELEMS = 1 << 27


def _device_kind(*tensors) -> str:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    kind = devs.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r} (cpu or cuda)")
    return kind


def _check_shapes(positions, masses):
    if positions.dim() != 2 or positions.shape[1] not in (2, 3):
        raise ValueError(
            f"positions must be [N, 2|3], got {tuple(positions.shape)}")
    if tuple(masses.shape) != (positions.shape[0],):
        raise ValueError(f"masses shape {tuple(masses.shape)} != "
                         f"{(positions.shape[0],)}")


def _pack4(positions, masses=None):
    """[N, 4] f32 rows (x, y, z|0, m|0), the kernels' float4 layout."""
    n, dim = positions.shape
    out = torch.zeros((n, 4), dtype=torch.float32, device=positions.device)
    out[:, :dim] = positions
    if masses is not None:
        out[:, 3] = masses
    return out


def _stream():
    return torch.cuda.current_stream().cuda_stream


# --- K2: one-sided tile ------------------------------------------------------

def pairwise_accel_plain(targets, src_pos, src_mass, softening=0.0,
                         guard=None):
    """Plain version of K2: Σ_s m_s·u³·(x_s − x_t) per target, [T, D], not
    scaled by G. Runs in the inputs' dtype, in row blocks."""
    if guard is None:
        guard = float(softening) == 0.0
    t = targets.shape[0]
    if t == 0:
        return targets.new_zeros(targets.shape)
    rows = max(1, min(t, _PLAIN_TILE_ELEMS // max(src_pos.shape[0], 1)))
    return torch.cat([
        _accel_rows(targets[r:r + rows], src_pos, src_mass, softening,
                    guard=guard)
        for r in range(0, t, rows)])


def pairwise_accel_cuda(targets, src_pos, src_mass, softening=0.0,
                        guard=None):
    """Un-G-scaled accelerations on ``targets`` from all sources, [T, D] f32.

    Counterpart of ``pairwise_accel_pallas``: K2 on CUDA tensors, its plain
    version on CPU tensors.
    """
    _check_shapes(src_pos, src_mass)
    if targets.dim() != 2 or targets.shape[1] != src_pos.shape[1]:
        raise ValueError(f"targets shape {tuple(targets.shape)} does not "
                         f"match sources {tuple(src_pos.shape)}")
    if guard is None:
        guard = float(softening) == 0.0
    targets = targets.to(torch.float32)
    src_pos = src_pos.to(torch.float32)
    src_mass = src_mass.to(torch.float32)
    if _device_kind(targets, src_pos, src_mass) == "cpu":
        return pairwise_accel_plain(targets, src_pos, src_mass, softening,
                                    guard)
    t, dim = targets.shape
    if t == 0:
        return targets.new_zeros((0, dim))
    tgt4 = _pack4(targets)
    src4 = _pack4(src_pos, src_mass)
    out = torch.empty((t, 4), dtype=torch.float32, device=targets.device)
    code = cuda_build.load_library().nbody_precise_accel(
        tgt4.data_ptr(), src4.data_ptr(), out.data_ptr(), t,
        src_pos.shape[0], dim, float(softening) ** 2, int(bool(guard)),
        _stream())
    cuda_build.check(code, "precise kernel")
    LAUNCHES["precise"] += 1
    return out[:, :dim]


# --- K1: Newton-3 block pairs ------------------------------------------------

def _tri_pair(k: int):
    """k-th unordered block pair (a, b), b <= a, k = a(a+1)/2 + b — the
    enumeration of csrc/symmetric.cu tri_pair."""
    a = (math.isqrt(8 * k + 1) - 1) // 2
    return a, k - a * (a + 1) // 2


def symmetric_forces_plain(positions, masses,
                           config: GravityConfig = DEFAULT_GRAVITY,
                           guard=None, block: int = SYM_BLOCK):
    """Plain version of K1: forces [N, D] from the kernel's block pairs.

    Diagonal blocks one-sided (target side only), off-diagonal blocks
    through ``_accel_rows_sym`` (both sides from one sweep). Runs in the
    inputs' dtype.
    """
    if guard is None:
        guard = float(config.softening) == 0.0
    n = positions.shape[0]
    nb = -(-n // block)
    soft = config.softening
    forces = torch.zeros_like(positions)
    for k in range(nb * (nb + 1) // 2):
        a, b = _tri_pair(k)
        ta, sb = slice(a * block, (a + 1) * block), slice(b * block,
                                                          (b + 1) * block)
        tp, tm = positions[ta], masses[ta]
        if a == b:
            forces[ta] += tm[:, None] * _accel_rows(tp, tp, tm, soft,
                                                    guard=guard)
            continue
        sp, sm = positions[sb], masses[sb]
        acc_t, part_s = _accel_rows_sym(tp, tm, sp, sm, soft, guard=guard)
        forces[ta] += tm[:, None] * acc_t
        forces[sb] += sm[:, None] * part_s
    return config.G * forces


def _symmetric_cuda(positions, masses, config, guard):
    n, dim = positions.shape
    pm4 = _pack4(positions, masses)
    acc = torch.zeros((n, 4), dtype=torch.float64, device=positions.device)
    lib = cuda_build.load_library()
    if lib.nbody_symmetric_block() != SYM_BLOCK:
        raise RuntimeError("csrc/symmetric.cu kSymBlock != SYM_BLOCK")
    code = lib.nbody_symmetric_forces(
        pm4.data_ptr(), acc.data_ptr(), n, dim,
        float(config.softening) ** 2, int(bool(guard)), _stream())
    cuda_build.check(code, "symmetric kernel")
    LAUNCHES["symmetric"] += 1
    # w already carries m_t·m_s, so this is the force, scaled by G only.
    return (config.G * acc[:, :dim]).to(torch.float32)


def brute_force_cuda(positions, masses,
                     config: GravityConfig = DEFAULT_GRAVITY,
                     mode: str = "precise", sort: bool = False,
                     guard=None):
    """Per-body forces [N, D] (fp32) via K2 (``"precise"``) or K1
    (``"symmetric"``). Counterpart of ``brute_force_pallas``.

    K1 takes any N that fits in memory: the card has no dispatch watchdog,
    so there is no segmented driver in front of it.
    """
    if mode not in ("precise", "mxu", "symmetric"):
        raise ValueError(
            f"mode must be 'precise', 'mxu' or 'symmetric', got {mode!r}")
    if mode == "mxu":
        raise NotImplementedError(
            "mode='mxu' (K5, _kernel_mxu) is not ported yet: ROADMAP queue 2")
    if sort:
        raise NotImplementedError(
            "sort=True needs ops/keys.py, which is not ported yet: ROADMAP "
            "queue 2 (K5) and queue 1 item 8")
    _check_shapes(positions, masses)
    if guard is None:
        guard = float(config.softening) == 0.0
    positions = positions.to(torch.float32)
    masses = masses.to(torch.float32)
    if mode == "precise":
        acc = pairwise_accel_cuda(positions, positions, masses,
                                  config.softening, guard)
        return (config.G * masses)[:, None] * acc
    if _device_kind(positions, masses) == "cpu":
        return symmetric_forces_plain(positions, masses, config, guard)
    return _symmetric_cuda(positions, masses, config, guard)
