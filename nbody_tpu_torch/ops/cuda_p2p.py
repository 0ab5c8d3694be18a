"""Leaf near field of the grid tree through the hand-written CUDA kernel K6.

Port of ``nbody_tpu.ops.pallas_p2p`` (``_kernel``, built by
``p2p_leaf_pallas``): per leaf row l and target c,
``Σ_s m_s·(x_s − x_c)·u³`` with u = (d² + ε²)^{-1/2} and u³ zeroed where the
raw d² < 1e-10, always. Mass 0 marks an invalid source.

* :func:`p2p_leaf_cuda` launches K6 (``csrc/p2p_leaf.cu``) on CUDA tensors,
  in fp32, and casts back to the targets' dtype; on CPU tensors it runs the
  plain version, ``grid_tree._point_mass_accel``. Each launch adds one to
  ``cuda_build.LAUNCHES["p2p_leaf"]``. It packs the fp32 buffers
  (:func:`p2p_leaf_pack`) and launches (:func:`p2p_leaf_launch`); the two
  halves are apart so that the kernel can be timed without its packing.
* :func:`p2p_leaf_plain` takes the JAX kernel's own layout, so the tests can
  hold it against ``p2p_leaf_pallas`` directly.

Layout. The TPU kernel reads sources transposed, ``[NL, 8, S]``, because
Mosaic cannot slice 1-D columns. K6 reads the packed float4 rows
``[NL, S, 4] = (x, y, z|0, m)`` that the tree's window gather already
produces (``grid_tree._window_rows_raw``), masses zeroed for invalid and
parity-masked cells by the caller.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from ..utils.cuda_build import LAUNCHES
from .cuda_brute import _device_kind, _stream
from .grid_tree import _point_mass_accel

#: Warps of one K6 CTA that split a leaf row's sources (csrc/p2p_leaf.cu
#: kP2PMaxWarps is the most it takes).
P2P_WARPS = 16

# Leaf rows per plain-version step: keeps each [rows, C, S] temporary at
# 2^27 elements however long the rows are.
_PLAIN_TILE_ELEMS = 1 << 27


def _check(tpos, src4):
    if tpos.dim() != 3 or tpos.shape[-1] not in (2, 3):
        raise ValueError(f"targets must be [B, C, 2|3], got "
                         f"{tuple(tpos.shape)}")
    if src4.dim() != 3 or src4.shape[-1] != 4 or \
            src4.shape[0] != tpos.shape[0]:
        raise ValueError(f"sources must be [B, S, 4] with B = "
                         f"{tpos.shape[0]}, got {tuple(src4.shape)}")


def p2p_plain(tpos, src4, softening):
    """Plain version of K6 on the packed layout: tpos [B, C, D], src4
    [B, S, 4] → [B, C, D] in the inputs' dtype, in row blocks."""
    dim = tpos.shape[-1]
    b, c, _ = tpos.shape
    rows = max(1, _PLAIN_TILE_ELEMS // max(c * src4.shape[1], 1))
    if b <= rows:
        return _point_mass_accel(tpos, src4[..., :dim], src4[..., 3],
                                 softening)
    return torch.cat([
        _point_mass_accel(tpos[r:r + rows], src4[r:r + rows, :, :dim],
                          src4[r:r + rows, :, 3], softening)
        for r in range(0, b, rows)])


def p2p_leaf_pack(tpos, src4):
    """K6's fp32 buffers for [B, C, D] targets and [B, S, 4] sources:
    targets as float4 rows [B, C, 4] (columns ≥ D zero), the sources, and
    the output [B, C, 4]."""
    b, c, dim = tpos.shape
    t4 = torch.zeros((b, c, 4), dtype=torch.float32, device=tpos.device)
    t4[..., :dim] = tpos
    out = torch.empty((b, c, 4), dtype=torch.float32, device=tpos.device)
    return t4, src4.to(torch.float32).contiguous(), out


def p2p_leaf_launch(t4, s4, out, dim, softening):
    """One K6 launch on :func:`p2p_leaf_pack`'s buffers, writing ``out``.
    It counts nothing: :func:`p2p_leaf_cuda` counts its launches."""
    b, c, _ = t4.shape
    s = s4.shape[1]
    nwarps = min(P2P_WARPS, max(1, -(-s // 32)))
    code = cuda_build.load_library().nbody_p2p_leaf(
        t4.data_ptr(), s4.data_ptr(), out.data_ptr(), b, c, s, dim,
        float(softening) ** 2, nwarps, _stream())
    cuda_build.check(code, "p2p_leaf kernel")


def p2p_leaf_cuda(tpos, src4, *, softening):
    """Leaf near-field accelerations [B, C, D], not scaled by G.

    tpos: [B, C, D] targets; src4: [B, S, 4] packed (pos|0, mass) sources,
    mass 0 for invalid ones. K6 on CUDA tensors (computed in fp32, cast
    back to ``tpos.dtype``), :func:`p2p_plain` on CPU tensors.
    """
    _check(tpos, src4)
    if _device_kind(tpos, src4) == "cpu":
        return p2p_plain(tpos, src4, softening)
    b, c, dim = tpos.shape
    if b == 0 or c == 0:
        return tpos.new_zeros(tpos.shape)
    t4, s4, out = p2p_leaf_pack(tpos, src4)
    p2p_leaf_launch(t4, s4, out, dim, softening)
    LAUNCHES["p2p_leaf"] += 1
    return out[..., :dim].to(tpos.dtype)


def p2p_leaf_plain(tpos4, src8, *, dim, softening):
    """Plain version in the JAX kernel's layout: tpos4 [NL, C, 4] (columns
    ≥ dim zero), src8 [NL, 8, S] (rows 0..dim−1 coordinates, row 3 mass)
    → [NL, C, 4], columns ≥ dim zero."""
    src4 = torch.cat([src8[:, :3, :], src8[:, 3:4, :]], dim=1).transpose(1, 2)
    acc = p2p_plain(tpos4[..., :dim], src4, softening)
    out = tpos4.new_zeros(tpos4.shape)
    out[..., :dim] = acc
    return out
