"""Morton (Z-order) and Hilbert space-filling-curve keys in plain PyTorch.

Port of ``nbody_tpu.ops.keys``. The keys are uint32 values; torch's uint32
supports few operators, so the bit arithmetic runs in int64 masked to 32
bits and the keys come back as int64 tensors that hold the uint32 values.
Quantization follows the JAX operation order in the positions' own dtype,
so on the same fp32 inputs the keys are bit-identical to the JAX package's.

Bit budget: ``bits`` per dimension interleaved into 32 bits (2D: ≤ 16,
3D: ≤ 10), as in the JAX package.
"""

from __future__ import annotations

import torch

MAX_BITS = {2: 16, 3: 10}

_MASK32 = 0xFFFFFFFF


def quantize(positions: torch.Tensor, bits: int, lo=None,
             hi=None) -> torch.Tensor:
    """Map positions [N, D] to integer grid coords [N, D] (int64) in
    [0, 2^bits).

    Bounds default to the data AABB with the reference's ×1.01 padding
    (``octree.cpp:170-194``), computed in the positions' dtype in the JAX
    order: centre and half-width, ``scale = 2^bits / (hi − lo)``, floor,
    then clip.
    """
    dt = positions.dtype
    if lo is None or hi is None:
        mins = positions.min(dim=0).values
        maxs = positions.max(dim=0).values
        center = 0.5 * (mins + maxs)
        half = (0.5 * (maxs - mins) * torch.tensor(1.01, dtype=dt)
                + torch.tensor(1e-30, dtype=dt))
        lo = center - half
        hi = center + half
    scale = float(2.0 ** bits) / (hi - lo)
    q = torch.floor((positions - lo) * scale).to(torch.int32)
    return torch.clamp(q, 0, (1 << bits) - 1).to(torch.int64)


def _spread2(x: torch.Tensor) -> torch.Tensor:
    """Insert one zero bit between each of the low 16 bits (2D interleave)."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the low 10 bits (3D interleave)."""
    x = x & 0x000003FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_key_from_coords(coords: torch.Tensor, bits: int) -> torch.Tensor:
    """Interleave integer grid coords [N, D] into Morton keys [N] (int64
    holding uint32)."""
    c = coords.to(torch.int64) & _MASK32
    if c.shape[-1] == 2:
        key = (_spread2(c[:, 0]) << 1) | _spread2(c[:, 1])
    else:
        key = ((_spread3(c[:, 0]) << 2) | (_spread3(c[:, 1]) << 1)
               | _spread3(c[:, 2]))
    return key & _MASK32


def morton_key(positions: torch.Tensor, bits: int | None = None):
    d = positions.shape[-1]
    bits = bits if bits is not None else MAX_BITS[d]
    return morton_key_from_coords(quantize(positions, bits), bits)


def hilbert_key_from_coords(coords: torch.Tensor, bits: int) -> torch.Tensor:
    """Hilbert-curve index [N] (int64 holding uint32) from grid coords [N, D].

    Skilling's algorithm (transpose form), vectorized over bodies, as in the
    JAX package: Gray-decode sweep from the top bit down, Gray encode, then
    the transposed bits Morton-interleaved with x[0] major.
    """
    d = coords.shape[-1]
    x = [coords[:, i].to(torch.int64) & _MASK32 for i in range(d)]

    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for i in range(d):
            cond = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            x0 = torch.where(cond, x[0] ^ p, x[0] ^ t)
            x[i] = torch.where(cond, x[i], x[i] ^ t)
            x[0] = x0
        q >>= 1

    for i in range(1, d):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((x[d - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    x = [xi ^ t for xi in x]
    return morton_key_from_coords(torch.stack(x, dim=-1), bits)


def hilbert_key(positions: torch.Tensor, bits: int | None = None):
    d = positions.shape[-1]
    bits = bits if bits is not None else MAX_BITS[d]
    return hilbert_key_from_coords(quantize(positions, bits), bits)


def sort_bodies_by_key(keys, positions, velocities, masses):
    """Stable argsort by key (``jnp.argsort`` is stable, and ties decide the
    order); returns (order, sorted keys, positions, velocities, masses)."""
    order = torch.argsort(keys, stable=True)
    return (order, keys[order], positions[order],
            None if velocities is None else velocities[order], masses[order])
