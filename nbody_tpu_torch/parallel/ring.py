"""Ring brute force over a device mesh: shard the targets, rotate the sources.

Port of ``nbody_tpu.parallel.ring``. Each shard owns a block of target
bodies and its force accumulator; source blocks (positions and masses in
one :meth:`Mesh.rotate`) travel around the ring one hop a step, so after P
steps and P − 1 hops every shard has summed the forces of every source
block. Targets are disjoint, so no sum across shards is needed.

**Newton-3 ring** (the default): each unordered shard pair once. The self
block goes through the one-sided engine; ⌈(P−1)/2⌉ forward hops each run
one two-output tile on shard b, giving its own rows and the Newton-3 share
of the block b−s it holds; a return pass carries the shares home. For even
P the step s = P/2 finds the pair (b, b + P/2) on both of its shards, so
each evaluates half of its rectangle (:func:`_tile_rows`): every card runs
one tile a forward step, and every pair term is evaluated once. Half the
arithmetic of the one-sided ring for the same bytes moved.

**Engines**, per shard: fp32 CUDA tensors run K2 (``local_accel_cuda``,
the one-sided tile) and K3 (``sym_accel_cuda``, the two-output tile); any
other tensors the plain rows of ``ops/brute_force.py`` in their own dtype
(as the JAX package's jnp engines off the TPU, the pair guard always on).

What differs from the JAX package, and why:

* One process drives the shards (``parallel/mesh.py``): ``lax.scan`` over
  the ring steps is a Python loop over steps and shards, and each shard's
  launches run with its card current.
* The one-sided ring makes P − 1 hops where the JAX scan makes P (its last
  brings every block home and is not read).
* At the even-P half step the two shards of a pair each evaluate one half
  of its rectangle, where the JAX program evaluates the whole tile on every
  shard and multiplies the shards b ≥ P/2 by 0. The pair terms are the
  same; only the order of some sums differs, and no card idles while the
  other evaluates the pair.

**Spans and counters** (``utils/profiling.py``, off by default; off, each
is one flag check and the forces are bit for bit those of spans on): per
shard r, on its own card's stream, ``ring.self/<r>`` around the self-block
engine call (the one-sided ring: each step's engine call) and
``ring.tile/<r>`` around each two-output tile it evaluates. A call adds to
the counters ``ring.tiles`` (the two-output tiles evaluated), ``ring.hops``
(the rotations, forward and return) and ``ring.bytes`` (the bytes that
leave their card: the scatter from the bodies' card, every rotation and
the gather; a move between two shards on one device counts 0). At
N = 5e6, D = 2, P = 4 in fp32: 8 tiles (each half-step half is one),
4 hops, 275,000,000 bytes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..ops import cuda_brute as cb
from ..ops.brute_force import _PAD_POS
from ..utils import profiling
from .mesh import Mesh, make_mesh, pad_to_multiple, shard_bodies

# local_accel(targets_pos [T,D], src_pos [S,D], src_mass [S], softening)
#   -> un-G-scaled acceleration contributions [T, D]
LocalAccelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, float],
                        torch.Tensor]

# sym_accel(t_pos [T,D], t_mass [T], src_pos [S,D], src_mass [S], softening)
#   -> (acc_t [T,D], part_s [S,D]): target rows and the sources' Newton-3
#   share from one pair sweep (see brute_force._accel_rows_sym).
SymAccelFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float],
    Tuple[torch.Tensor, torch.Tensor]]


def plain_local_accel(targets, src_pos, src_mass, softening):
    """The plain one-sided engine: ``_accel_rows`` in row blocks, guarded."""
    return cb.pairwise_accel_plain(targets, src_pos, src_mass, softening,
                                   guard=True)


def plain_sym_accel(tpos, tmass, spos, smass, softening):
    """The plain two-output engine: K3's plain version, guarded, in the
    inputs' dtype."""
    return cb.sym_tile_plain(tpos, tmass, spos, smass, softening, guard=True)


def _engines(positions: torch.Tensor, local_accel, sym_accel):
    """The default engines for these bodies: K2/K3 for fp32 CUDA tensors,
    the plain rows otherwise."""
    kernel = positions.is_cuda and positions.dtype == torch.float32
    if local_accel is None:
        local_accel = cb.local_accel_cuda if kernel else plain_local_accel
    if sym_accel is None:
        sym_accel = cb.sym_accel_cuda if kernel else plain_sym_accel
    return local_accel, sym_accel


def _pad(positions, masses, n_pad):
    n, d = positions.shape
    if n_pad == n:
        return positions, masses
    return (torch.cat([positions, positions.new_full((n_pad - n, d),
                                                     _PAD_POS)]),
            torch.cat([masses, masses.new_zeros((n_pad - n,))]))


_OFF = contextlib.nullcontext()


def _shard_span(kind: str, mesh: Mesh, r: int):
    """The span ``ring.<kind>/<r>`` on shard r's card; a shared no-op
    context while spans are off."""
    if not profiling.spans_enabled():
        return _OFF
    return profiling.span(f"ring.{kind}/{r}", mesh.devices[r])


def _card(device: torch.device) -> torch.device:
    """The device with its index: a CPU tensor's missing index is 0."""
    return torch.device(device.type, device.index or 0)


def _count_bytes(xs: Sequence, src: Sequence[torch.device],
                 dst: Sequence[torch.device]) -> None:
    """Add to ``ring.bytes`` the bytes of each ``xs[i]`` (a tensor or a
    tuple of them) that goes from ``src[i]`` to another card ``dst[i]``."""
    if not profiling.spans_enabled():
        return
    moved = 0
    for x, a, b in zip(xs, src, dst):
        if _card(a) != _card(b):
            moved += sum(t.numel() * t.element_size()
                         for t in ((x,) if torch.is_tensor(x) else x))
    profiling.count("ring.bytes", moved)


def _rotate(mesh: Mesh, xs, hops: int = 1) -> list:
    """:meth:`Mesh.rotate`, counted under ``ring.hops`` and
    ``ring.bytes``."""
    if profiling.spans_enabled():
        p = mesh.num_shards
        profiling.count("ring.hops")
        _count_bytes(xs, mesh.devices,
                     [mesh.devices[(r + hops) % p] for r in range(p)])
    return mesh.rotate(xs, hops)


def _forward_steps(p: int) -> int:
    """⌈(P−1)/2⌉ = ⌊P/2⌋ forward hops; at even P the last step's pairs are
    split between their two shards (:func:`_tile_rows`)."""
    return p // 2


_ALL = slice(None)


def _tile_rows(s: int, p: int, shard: int, rows: int) -> Tuple[slice, slice]:
    """(target rows, source rows) of the tile ``shard`` evaluates at step s:
    all of both, except at the even-P half step s = P/2, where shards b and
    b + P/2 hold the same pair. There, with h = ⌊rows/2⌋, shard b < P/2
    takes its targets [:h] against all of block b + P/2, and shard b + P/2
    all its targets against block b's rows [h:]: the halves cover the
    rectangle once and differ by at most one row of block b."""
    if p % 2 or s != p // 2:
        return _ALL, _ALL
    h = rows // 2
    return (slice(0, h), _ALL) if shard < p // 2 else (_ALL, slice(h, None))


def _add_rows(x: torch.Tensor, y: torch.Tensor, rows: slice) -> torch.Tensor:
    """x + y, where y holds x's ``rows`` alone."""
    if rows == _ALL:
        return x + y
    out = x.clone()
    out[rows] += y
    return out


def _ring_one_sided(mesh: Mesh, pos, mass, softening, local_accel):
    """P steps: each shard's tile against the resident sources, with one
    hop of the sources (positions and masses together) between steps:
    P − 1 hops, as the P-th would only bring every block home."""
    p = mesh.num_shards
    acc = [torch.zeros_like(x) for x in pos]
    src = list(zip(pos, mass))

    def step(r):
        with _shard_span("self", mesh, r):
            return acc[r] + local_accel(pos[r], src[r][0], src[r][1],
                                        softening)

    for s in range(p):
        acc = mesh.per_shard(step)
        if s < p - 1:
            src = _rotate(mesh, src)
    return acc


def _ring_symmetric(mesh: Mesh, pos, mass, softening, local_accel,
                    sym_accel):
    """Self blocks, ⌈(P−1)/2⌉ forward hops of two-output tiles, then the
    return pass: partials added in descending s with one reverse hop after
    each add, so p_s has travelled s hops when it ends."""
    p = mesh.num_shards

    def self_block(r):
        with _shard_span("self", mesh, r):
            return local_accel(pos[r], pos[r], mass[r], softening)

    def tile(r):
        t, u = _tile_rows(s, p, r, pos[r].shape[0])
        profiling.count("ring.tiles")
        with _shard_span("tile", mesh, r):
            acc_t, part_s = sym_accel(pos[r][t], mass[r][t], src[r][0][u],
                                      src[r][1][u], softening)
        return (acc_t, t), (part_s, u)

    acc = mesh.per_shard(self_block)
    src = list(zip(pos, mass))
    parts = []
    for s in range(1, _forward_steps(p) + 1):
        src = _rotate(mesh, src)
        tiles = mesh.per_shard(tile)
        acc = [_add_rows(a, *t[0]) for a, t in zip(acc, tiles)]
        parts.append([t[1] for t in tiles])
    ret = [torch.zeros_like(x) for x in pos]
    for part_s in reversed(parts):
        ret = [_add_rows(x, *q) for x, q in zip(ret, part_s)]
        ret = _rotate(mesh, ret, -1)
    return [a + b for a, b in zip(acc, ret)]


def _finish(mesh: Mesh, acc, mass, config: GravityConfig, n: int,
            device: torch.device) -> torch.Tensor:
    """Scale each shard by G·m, gather in shard order on ``device``, cut
    the padding."""
    forces = [(config.G * m)[:, None] * a for a, m in zip(acc, mass)]
    return torch.cat([f.to(device) for f in forces])[:n]


def ring_brute_force(
    positions: torch.Tensor,
    masses: torch.Tensor,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    local_accel: Optional[LocalAccelFn] = None,
    symmetric: Optional[bool] = None,
    sym_accel: Optional[SymAccelFn] = None,
) -> torch.Tensor:
    """Per-body forces [N, D] computed over every shard of ``mesh`` (by
    default every visible CUDA device), returned on the bodies' device.

    ``local_accel`` / ``sym_accel`` are the per-shard engines (module
    docstring for the defaults). ``symmetric`` (default: on, unless a
    one-sided ``local_accel`` is given without a ``sym_accel``) runs the
    Newton-3 ring, else the one-sided ring. N is padded to a multiple of P
    with zero-mass bodies at 2e9.
    """
    mesh = make_mesh() if mesh is None else mesh
    mesh.check(positions, masses)
    if symmetric is None:
        symmetric = local_accel is None or sym_accel is not None
    local_accel, sym_accel = _engines(positions, local_accel, sym_accel)
    n = positions.shape[0]
    soft = float(config.softening)
    pos_p, mass_p = _pad(positions, masses,
                         pad_to_multiple(n, mesh.num_shards))
    pos, mass = shard_bodies(mesh, pos_p, mass_p)
    p = mesh.num_shards
    _count_bytes(list(zip(pos, mass)), [positions.device] * p, mesh.devices)
    if symmetric:
        acc = _ring_symmetric(mesh, pos, mass, soft, local_accel, sym_accel)
    else:
        acc = _ring_one_sided(mesh, pos, mass, soft, local_accel)
    # _finish gathers each shard's [rows, D] forces, acc's size and dtype.
    _count_bytes(acc, mesh.devices, [positions.device] * p)
    return _finish(mesh, acc, mass, config, n, positions.device)

