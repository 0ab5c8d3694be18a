"""Brute-force all-pairs forces through hand-written CUDA kernels (fp32).

Port of the five ``nbody_tpu.ops.pallas_brute`` kernels, each with its
plain PyTorch version beside it:

* K2 ``"precise"`` (``_kernel_precise``): one-sided Σ_s m_s·u³·Δ per target,
  ``csrc/precise.cu``; plain version :func:`pairwise_accel_plain`.
* K1 ``"symmetric"`` (``_kernel_symmetric``): Newton-3, each unordered block
  pair swept once, ``csrc/symmetric.cu``; plain version
  :func:`symmetric_forces_plain`, which enumerates the same block pairs.
* K3 (``_kernel_sym_tile``): the Newton-3 rectangle over two disjoint
  blocks, :func:`sym_tile_cuda`, ``csrc/sym_tile.cu``; plain version
  :func:`sym_tile_plain`. It carries the Newton-3 ring's cross-shard
  tiles (``parallel/ring.py``), one launch a tile.

  K1's off-diagonal block pairs and K3's tiles run on one Newton-3 tile
  engine, ``csrc/newton3_tile.cuh``: a lane owns 8 targets, a warp passes
  each source's partial from lane to lane (one shuffle per dimension and
  8 pairs) and writes it once to shared slots of its own, and the CTA adds
  both sides to fp64 device memory once per block pair. What bounds it is
  FP32 issue (12 instructions a pair in 2D, 16 in 3D, and a MUFU rsqrt),
  not bytes. K1's diagonal blocks are a second launch of the same call.
* K4 (``_kernel_fused_steps``): K Euler/leapfrog steps of N ≤ 2048 bodies in
  one launch, :func:`fused_smalln_simulate`, ``csrc/fused_steps.cu``: one
  thread-block cluster of :func:`fused_cluster_size` CTAs, each owning a
  slice of the bodies and holding every position, exchanged through
  distributed shared memory once a force evaluation; plain version
  :func:`fused_smalln_plain`.
* K5 ``"mxu"`` (``_kernel_mxu``): the one-sided tile in block-centred
  matmul form, ``csrc/mxu.cu``; plain version :func:`mxu_accel_plain`.

The exact sum as ``Simulation("brute")`` runs it on the card is
:func:`brute_force_routed`: K1 from :data:`K1_MIN_N` bodies up, K2 below.
The threshold is measured, K1 against K2 through :func:`brute_force_cuda`
on an H100 at N = 1024 to 262,144 in 2D and 3D (CUDA events, median of 3;
``PERF.md`` § 6): K1 is faster in both from 16,384 up (0.32 against 0.51
ms in 2D there, 18.9 against 29.1 at 262,144), K2 at 4096 and 8192, where
K1's one CTA a block leaves most SMs idle and a call is mostly the host's
time around its launches. The JAX package
takes its one-sided kernel at every N, a choice made for the TPU. K1 sums
in fp64 by atomics, so its last bits can change from run to run: the
route's results agree with the JAX package's within tolerance, not bit for
bit. ``mode="precise"`` and ``"symmetric"`` stay as they are; K2 is also
the ring's self-block engine (:func:`local_accel_cuda`).

Dispatch: a wrapper runs the plain version only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises; nothing falls back. Each
launch adds one to ``cuda_build.LAUNCHES[<kernel>]``.

Guard policy, as the TPU kernels (``pallas_brute.py:48-60``): the reference
pair skip (d² < 1e-10) is on only when softening == 0 unless ``guard`` says
otherwise; ``"mxu"`` always guards. The plain ``brute_force`` oracle always
guards.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..utils import cuda_build, profiling
from ..utils.cuda_build import LAUNCHES
from .brute_force import _PAD_POS, _accel_rows, _accel_rows_sym, \
    _diffs_d2, _guarded_u3
from .keys import morton_key

#: Square block of K1 and K3: kN3Block = 32 · kN3Warps · kN3R bodies
#: (csrc/newton3_tile.cuh).
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


def _precise_cuda(targets, src_pos, src_mass, softening, guard):
    t, dim = targets.shape
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


def pairwise_accel_cuda(targets, src_pos, src_mass, softening=0.0,
                        guard=None, mode: str = "precise",
                        block_t: int = 256):
    """Un-G-scaled accelerations on ``targets`` from all sources, [T, D] f32.

    Counterpart of ``pairwise_accel_pallas``: K2 (``mode="precise"``) or K5
    (``mode="mxu"``, centred on blocks of ``min(block_t, max(8, T))``
    targets, always guarded) on CUDA tensors, their plain versions on CPU
    tensors.
    """
    if mode not in ("precise", "mxu"):
        raise ValueError(f"mode must be 'precise' or 'mxu', got {mode!r}")
    _check_shapes(src_pos, src_mass)
    if targets.dim() != 2 or targets.shape[1] != src_pos.shape[1]:
        raise ValueError(f"targets shape {tuple(targets.shape)} does not "
                         f"match sources {tuple(src_pos.shape)}")
    if guard is None:
        guard = float(softening) == 0.0
    targets = targets.to(torch.float32)
    src_pos = src_pos.to(torch.float32)
    src_mass = src_mass.to(torch.float32)
    t, dim = targets.shape
    if mode == "mxu":
        return _mxu(targets, src_pos, src_mass, softening,
                    min(block_t, max(8, t)))
    if _device_kind(targets, src_pos, src_mass) == "cpu":
        return pairwise_accel_plain(targets, src_pos, src_mass, softening,
                                    guard)
    if t == 0:
        return targets.new_zeros((0, dim))
    return _precise_cuda(targets, src_pos, src_mass, softening, guard)


def local_accel_cuda(targets, src_pos, src_mass, softening):
    """``LocalAccelFn``-shaped adapter (the ring's one-sided engine), through
    K2. Counterpart of ``pallas_local_accel``."""
    return pairwise_accel_cuda(targets, src_pos, src_mass,
                               softening=float(softening))


# --- K5: one-sided tile in block-centred matmul form --------------------------

#: Largest centring block K5 takes: one CTA of block_t threads per block.
MXU_MAX_BLOCK = 1024


def _check_block_t(block_t: int) -> None:
    if not 1 <= block_t <= MXU_MAX_BLOCK:
        raise ValueError(f"mode='mxu' needs 1 <= block_t <= {MXU_MAX_BLOCK} "
                         f"(one CTA per centring block), got {block_t}")


def mxu_accel_plain(targets, src_pos, src_mass, softening=0.0,
                    block_t: int = 256):
    """Plain version of K5: un-G-scaled accelerations [T, D] by the
    block-centred matmul form of ``_kernel_mxu``.

    For each block of ``block_t`` targets with c its first target:
    a = u³ @ [m(x − c), m], contrib = a[:, :D] − (x_t − c)·a[:, D], with u³
    guarded on the unsoftened d² (always). The centred sources are formed as
    m·(x − c), as ``csrc/mxu.cu`` does; the JAX kernel forms m·x − c·m. The
    reduction is ``torch.bmm``, which must run in full fp32: this is K5's
    yardstick on the card, so TF32 is refused.
    """
    _check_block_t(block_t)
    if targets.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("mxu_accel_plain needs full-fp32 matmul: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    t, dim = targets.shape
    s = src_pos.shape[0]
    if t == 0:
        return targets.new_zeros(targets.shape)
    nblk = -(-t // block_t)
    tgt = torch.cat([targets, targets.new_full((nblk * block_t - t, dim),
                                               _PAD_POS)])
    per = max(1, _PLAIN_TILE_ELEMS // max(block_t * s, 1))
    out = []
    for b0 in range(0, nblk, per):
        tb = tgt[b0 * block_t:(b0 + per) * block_t]
        k = tb.shape[0] // block_t
        c = tb.view(k, block_t, dim)[:, 0, :]  # [k, D]
        _, d2 = _diffs_d2(tb, src_pos)
        u3 = _guarded_u3(d2, softening, guard=True).view(k, block_t, s)
        cen = torch.cat([
            src_mass[None, :, None] * (src_pos[None, :, :] - c[:, None, :]),
            src_mass[None, :, None].expand(k, s, 1)], dim=-1)  # [k, S, D+1]
        a = torch.bmm(u3, cen)
        rel = tb.view(k, block_t, dim) - c[:, None, :]
        out.append((a[..., :dim] - rel * a[..., dim:]).reshape(-1, dim))
    return torch.cat(out)[:t]


def _mxu(targets, src_pos, src_mass, softening, block_t):
    """K5 on CUDA f32 tensors, its plain version on CPU ones."""
    if _device_kind(targets, src_pos, src_mass) == "cpu":
        return mxu_accel_plain(targets, src_pos, src_mass, softening,
                               block_t)
    _check_block_t(block_t)
    t, dim = targets.shape
    if t == 0:
        return targets.new_zeros((0, dim))
    tgt4 = _pack4(targets)
    src4 = _pack4(src_pos, src_mass)
    out = torch.empty((t, 4), dtype=torch.float32, device=targets.device)
    code = cuda_build.load_library().nbody_mxu_accel(
        tgt4.data_ptr(), src4.data_ptr(), out.data_ptr(), t,
        src_pos.shape[0], dim, block_t, float(softening) ** 2, _stream())
    cuda_build.check(code, "mxu kernel")
    LAUNCHES["mxu"] += 1
    return out[:, :dim]


# --- K1: Newton-3 block pairs ------------------------------------------------

def _tri_pair(k: int):
    """k-th unordered block pair (a, b), b <= a, k = a(a+1)/2 + b — the
    enumeration of csrc/newton3_tile.cuh tri_pair."""
    a = (math.isqrt(8 * k + 1) - 1) // 2
    return a, k - a * (a + 1) // 2


def _lower_pair(k: int):
    """k-th block pair (a, b), b < a, of the strict lower triangle: K1's
    off-diagonal walk, (a + 1, b) for the k-th pair of :func:`_tri_pair`."""
    a, b = _tri_pair(k)
    return a + 1, b


def _rect_pair(k: int, ns: int):
    """K3's walk: (target block, source block) of tile k of a rectangle
    with ``ns`` source blocks."""
    return divmod(k, ns)


def symmetric_forces_plain(positions, masses,
                           config: GravityConfig = DEFAULT_GRAVITY,
                           guard=None, block: int = SYM_BLOCK):
    """Plain version of K1: forces [N, D] from the kernel's block pairs.

    The diagonal blocks one-sided (target side only), then the strict lower
    triangle's block pairs through ``_accel_rows_sym`` (both sides from one
    sweep), with each side's mass applied to its sum, as the kernel's two
    launches do. Runs in the inputs' dtype.
    """
    if guard is None:
        guard = float(config.softening) == 0.0
    n = positions.shape[0]
    nb = -(-n // block)
    soft = config.softening
    forces = torch.zeros_like(positions)

    def rows(a):
        return slice(a * block, (a + 1) * block)

    for a in range(nb):
        tp, tm = positions[rows(a)], masses[rows(a)]
        forces[rows(a)] += tm[:, None] * _accel_rows(tp, tp, tm, soft,
                                                     guard=guard)
    for k in range(nb * (nb - 1) // 2):
        a, b = _lower_pair(k)
        tp, tm = positions[rows(a)], masses[rows(a)]
        sp, sm = positions[rows(b)], masses[rows(b)]
        acc_t, part_s = _accel_rows_sym(tp, tm, sp, sm, soft, guard=guard)
        forces[rows(a)] += tm[:, None] * acc_t
        forces[rows(b)] += sm[:, None] * part_s
    return config.G * forces


def _symmetric_cuda(positions, masses, config, guard):
    n, dim = positions.shape
    pm4 = _pack4(positions, masses)
    acc = torch.zeros((n, 4), dtype=torch.float64, device=positions.device)
    lib = cuda_build.load_library()
    if lib.nbody_symmetric_block() != SYM_BLOCK:
        raise RuntimeError("csrc/newton3_tile.cuh kN3Block != SYM_BLOCK")
    code = lib.nbody_symmetric_forces(
        pm4.data_ptr(), acc.data_ptr(), n, dim,
        float(config.softening) ** 2, int(bool(guard)), _stream())
    cuda_build.check(code, "symmetric kernel")
    LAUNCHES["symmetric"] += 1
    # Each side's sum already carries both masses: the force, scaled by G
    # only.
    return (config.G * acc[:, :dim]).to(torch.float32)


def brute_force_cuda(positions, masses,
                     config: GravityConfig = DEFAULT_GRAVITY,
                     mode: str = "precise", sort: bool = False,
                     guard=None, block_t: int | None = None):
    """Per-body forces [N, D] (fp32) via K2 (``"precise"``), K1
    (``"symmetric"``) or K5 (``"mxu"``). Counterpart of
    ``brute_force_pallas``.

    ``block_t`` matters only to ``"mxu"``, whose centring blocks it sets
    (default 256, clamped to N rounded up to 128, as the JAX kernel); the
    other kernels' blocks are fixed by their sources. ``sort=True``
    Morton-orders the bodies (stable argsort), computes the forces and
    scatters them back, for every mode.

    K1 takes any N that fits in memory: the card has no dispatch watchdog,
    so ``"symmetric"`` makes one K1 launch at any N, where the JAX package
    splits large N into segments (``brute_force_pallas_segmented``).
    """
    if mode not in ("precise", "mxu", "symmetric"):
        raise ValueError(
            f"mode must be 'precise', 'mxu' or 'symmetric', got {mode!r}")
    _check_shapes(positions, masses)
    if sort:
        order = torch.argsort(morton_key(positions), stable=True)
        f_sorted = brute_force_cuda(positions[order], masses[order], config,
                                    mode=mode, guard=guard, block_t=block_t)
        out = torch.empty_like(f_sorted)
        out[order] = f_sorted
        return out
    if guard is None:
        guard = float(config.softening) == 0.0
    positions = positions.to(torch.float32)
    masses = masses.to(torch.float32)
    if mode == "symmetric":
        if _device_kind(positions, masses) == "cpu":
            return symmetric_forces_plain(positions, masses, config, guard)
        return _symmetric_cuda(positions, masses, config, guard)
    if mode == "mxu":
        n = positions.shape[0]
        bt = min(256 if block_t is None else block_t,
                 max(1, -(-n // 128) * 128))
        acc = _mxu(positions, positions, masses, config.softening, bt)
    else:
        acc = pairwise_accel_cuda(positions, positions, masses,
                                  config.softening, guard)
    return (config.G * masses)[:, None] * acc


#: Smallest N at which :func:`brute_force_routed` takes K1, in 2D and 3D
#: (the measurement is in the module docstring). Below it K1's CTAs, one a
#: 1024-body block on the diagonal and one a block pair off it, are too few
#: to fill the card's SMs.
K1_MIN_N = 16_384


def brute_force_routed(positions, masses,
                       config: GravityConfig = DEFAULT_GRAVITY):
    """The exact sum [N, D] (fp32) by the faster kernel for N:
    :func:`brute_force_cuda` with ``mode="symmetric"`` (K1, each unordered
    pair evaluated once) from :data:`K1_MIN_N` bodies up, ``"precise"`` (K2,
    every ordered pair) below. ``Simulation("brute")``'s engine on the card.

    The same pair law, softening, guard policy and fp32 pair terms either
    way; K1 accumulates in fp64 by atomics, so its last bits can change
    from run to run, and the results agree with the JAX package's one-sided
    sum within tolerance, not bit for bit. With spans on, each call counts
    under ``brute.k1`` or ``brute.k2``.
    """
    if positions.shape[0] >= K1_MIN_N:
        profiling.count("brute.k1")
        return brute_force_cuda(positions, masses, config, mode="symmetric")
    profiling.count("brute.k2")
    return brute_force_cuda(positions, masses, config, mode="precise")


# --- K3: Newton-3 rectangle over two disjoint blocks -------------------------

def sym_tile_plain(tpos, tmass, spos, smass, softening=0.0, guard=None):
    """Plain version of K3: (acc_t [T, D], part_s [S, D]) in acceleration
    units, with the kernel's guard policy: ``_accel_rows_sym`` over the
    whole rectangle, in target-row blocks of bounded size. Runs in the
    inputs' dtype."""
    if guard is None:
        guard = float(softening) == 0.0
    t, s = tpos.shape[0], spos.shape[0]
    acc_t = tpos.new_zeros(tpos.shape)
    part_s = spos.new_zeros(spos.shape)
    rows = max(1, _PLAIN_TILE_ELEMS // max(s, 1))
    for r in range(0, t, rows):
        a, p = _accel_rows_sym(tpos[r:r + rows], tmass[r:r + rows], spos,
                               smass, softening, guard=guard)
        acc_t[r:r + rows] = a
        part_s += p
    return acc_t, part_s


def _sym_tile_launch(tpos, tmass, spos, smass, softening, guard):
    (t, dim), s = tpos.shape, spos.shape[0]
    dev = tpos.device
    acc_t = torch.zeros((t, 4), dtype=torch.float64, device=dev)
    acc_s = torch.zeros((s, 4), dtype=torch.float64, device=dev)
    if t and s:
        tgt4, src4 = _pack4(tpos, tmass), _pack4(spos, smass)
        code = cuda_build.load_library().nbody_sym_tile(
            tgt4.data_ptr(), src4.data_ptr(), acc_t.data_ptr(),
            acc_s.data_ptr(), t, s, dim, float(softening) ** 2,
            int(bool(guard)), _stream())
        cuda_build.check(code, "sym_tile kernel")
        LAUNCHES["sym_tile"] += 1
    return (acc_t[:, :dim].to(torch.float32),
            acc_s[:, :dim].to(torch.float32))


def sym_tile_cuda(tpos, tmass, spos, smass, softening=0.0, guard=None):
    """Newton-3 rectangular tile for DISJOINT body blocks (fp32).

    Counterpart of ``pallas_sym_tile``: returns (acc_t [T, D], part_s
    [S, D]) in acceleration units, not G-scaled: acc_t = Σ_s m_s·u³·Δ and
    part_s = −Σ_t m_t·u³·Δ, so each unordered cross pair is swept once.
    K3 on CUDA tensors, one launch at any T and S (the kernel counts its
    tiles in 64 bits and walks them grid-stride; the JAX package splits
    above 524,288 rows a side for a TPU compile limit the card does not
    have), the plain version on CPU tensors. The guard defaults to on only
    at softening == 0.
    """
    _check_shapes(tpos, tmass)
    _check_shapes(spos, smass)
    if tpos.shape[1] != spos.shape[1]:
        raise ValueError(f"target dim {tpos.shape[1]} != source dim "
                         f"{spos.shape[1]}")
    if guard is None:
        guard = float(softening) == 0.0
    tpos, tmass, spos, smass = (x.to(torch.float32)
                                for x in (tpos, tmass, spos, smass))
    if _device_kind(tpos, tmass, spos, smass) == "cpu":
        return sym_tile_plain(tpos, tmass, spos, smass, softening, guard)
    return _sym_tile_launch(tpos, tmass, spos, smass, softening, guard)


def sym_accel_cuda(tpos, tmass, spos, smass, softening):
    """``SymAccelFn``-shaped adapter (the symmetric ring's engine).
    Counterpart of ``pallas_sym_accel``."""
    return sym_tile_cuda(tpos, tmass, spos, smass, softening=float(softening))


# --- K4: fused small-N stepping ----------------------------------------------

#: Largest N K4 takes: every CTA of its cluster holds all positions, twice,
#: in shared memory (``kFusedMax``).
FUSED_SMALLN_MAX = 2048
#: What :func:`set_fused_cluster_size` takes: 0 (the card decides), or
#: ``kFusedCluster`` and ``kFusedPortableCluster`` of ``fused_steps.cu``.
FUSED_CLUSTER_SIZES = (0, 16, 8)
_INTEGRATORS = ("euler", "leapfrog")


def _check_integrator(integrator: str) -> None:
    if integrator not in _INTEGRATORS:
        raise ValueError(f"integrator must be one of {_INTEGRATORS}, "
                         f"got {integrator!r}")


def fused_smalln_plain(positions, velocities, masses, *, dt, num_steps,
                       g=1.0, softening=0.0, integrator="euler", guard=None):
    """Plain version of K4: the same K-step loop in torch, in the inputs'
    dtype, through ``_accel_rows`` with the kernels' guard policy.
    Returns (positions, velocities)."""
    _check_integrator(integrator)
    if guard is None:
        guard = float(softening) == 0.0

    def accel(p):
        return _accel_rows(p, p, masses, softening, guard=guard) * g

    pos, vel = positions, velocities
    half = 0.5 * dt
    for _ in range(num_steps):
        if integrator == "euler":
            vel = vel + accel(pos) * dt
            pos = pos + vel * dt
        else:  # KDK, two force evaluations, nothing carried
            v_half = vel + accel(pos) * half
            pos = pos + v_half * dt
            vel = v_half + accel(pos) * half
    return pos, vel


def fused_cluster_size() -> int:
    """CTAs (SMs) of K4's thread-block cluster on the current card: 16
    where the card places such a cluster with the kernel's shared memory,
    else the portable 8, or the size :func:`set_fused_cluster_size` set.
    Needs a card; raises if the card's query fails."""
    c = ctypes.c_int(0)
    cuda_build.check(
        cuda_build.load_library().nbody_fused_cluster_size(ctypes.byref(c)),
        "fused_steps cluster size query")
    return c.value


def set_fused_cluster_size(c: int) -> None:
    """Makes later K4 launches take a cluster of ``c`` CTAs: 16 or the
    portable 8, or 0 for the size the card's occupancy decides. Needs a
    card."""
    if c not in FUSED_CLUSTER_SIZES:
        raise ValueError(f"cluster size must be one of {FUSED_CLUSTER_SIZES}, "
                         f"got {c!r}")
    cuda_build.check(cuda_build.load_library().nbody_fused_force_cluster(c),
                     "fused_steps cluster size")


def fused_smalln_simulate(positions, velocities, masses, *, dt,
                          num_steps: int, g=1.0, softening=0.0,
                          integrator: str = "euler", guard=None):
    """``num_steps`` small-N integration steps in ONE launch → (pos, vel).

    Counterpart of ``fused_smalln_simulate``: exact all-pairs accelerations
    scaled by ``g``, Euler (v += g·a·dt; x += v·dt) or KDK leapfrog.
    N ≤ ``FUSED_SMALLN_MAX``. K4 on CUDA tensors, :func:`fused_smalln_plain`
    on CPU tensors; fp32. Where the JAX kernel evaluates the force twice a
    leapfrog step, K4 carries the force at the end of a step into the next
    (the same positions and code, so the same result): one sweep a step and
    one before the first.
    """
    n, dim = positions.shape
    if n > FUSED_SMALLN_MAX:
        raise ValueError(f"fused_smalln_simulate: N={n} > {FUSED_SMALLN_MAX}")
    _check_integrator(integrator)
    _check_shapes(positions, masses)
    if tuple(velocities.shape) != (n, dim):
        raise ValueError(f"velocities shape {tuple(velocities.shape)} != "
                         f"{(n, dim)}")
    if guard is None:
        guard = float(softening) == 0.0
    positions, velocities, masses = (x.to(torch.float32) for x in
                                     (positions, velocities, masses))
    if _device_kind(positions, velocities, masses) == "cpu":
        return fused_smalln_plain(
            positions, velocities, masses, dt=dt, num_steps=num_steps, g=g,
            softening=softening, integrator=integrator, guard=guard)
    if n == 0:
        return positions.clone(), velocities.clone()
    pm4 = _pack4(positions, masses)
    vel4 = _pack4(velocities)
    code = cuda_build.load_library().nbody_fused_steps(
        pm4.data_ptr(), vel4.data_ptr(), n, dim, int(num_steps), float(dt),
        float(g), float(softening) ** 2, int(bool(guard)),
        int(integrator == "leapfrog"), _stream())
    cuda_build.check(code, "fused_steps kernel")
    LAUNCHES["fused_steps"] += 1
    return pm4[:, :dim], vel4[:, :dim]
