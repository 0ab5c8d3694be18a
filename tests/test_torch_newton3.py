"""The Newton-3 tile engine of K1 and K3 (csrc/newton3_tile.cuh).

On the CPU: the Python mirrors of the kernels' block-pair walks, the block
constants the wrappers rely on against the CUDA sources (read as text: no
nvcc here), and K1's plain version at the kernel's own block size against
the JAX Pallas symmetric kernel in interpret mode. The ``cuda``-marked
tests run K1 and K3 themselves against their plain versions and skip
without a card; they need no JAX, so ``pytest --noconftest -m cuda`` runs
this file on a card where JAX is not installed.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops import cuda_brute as cb
from nbody_tpu_torch.utils import cuda_build
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

CSRC = Path(cb.__file__).resolve().parent.parent / "csrc"
GRIDS = [1, 7, 132, 528]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 and K3 are built by nvcc and run "
                    "only on the card")
    return torch.device("cuda", 0)


# --- (a) the block-pair walks -----------------------------------------------

def _grid_stride(pairs, grid):
    """The block pairs the CTAs of a ``grid``-CTA launch take, in the
    kernels' grid-stride order: CTA c takes c, c + grid, ..."""
    return [k for c in range(grid) for k in range(c, pairs, grid)]


@pytest.mark.parametrize("grid", GRIDS)
def test_k1_walk_covers_each_unordered_block_pair_once(grid):
    """The diagonal launch (one CTA a block) and the off-diagonal walk over
    the strict lower triangle, in grid-stride order, take every unordered
    block pair exactly once."""
    for nb in range(1, 65):
        pairs = [(a, a) for a in range(nb)]
        pairs += [cb._lower_pair(k)
                  for k in _grid_stride(nb * (nb - 1) // 2, grid)]
        assert all(b <= a < nb for a, b in pairs)
        assert sorted(pairs) == [(a, b) for a in range(nb)
                                 for b in range(a + 1)], (nb, grid)


@pytest.mark.parametrize("grid", GRIDS)
def test_k3_walk_covers_each_tile_once(grid):
    for nt in (1, 2, 5, 64):
        for ns in (1, 3, 64):
            tiles = [cb._rect_pair(k, ns)
                     for k in _grid_stride(nt * ns, grid)]
            assert sorted(tiles) == [(a, b) for a in range(nt)
                                     for b in range(ns)], (nt, ns, grid)


def _tri_pair_as_the_kernel(k):
    """csrc/newton3_tile.cuh tri_pair: a double sqrt, then integer
    corrections."""
    r = int((math.sqrt(8.0 * float(k) + 1.0) - 1.0) * 0.5)
    while r * (r + 1) // 2 > k:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= k:
        r += 1
    return r, k - r * (r + 1) // 2


def test_tri_pair_float_root_matches_integer_root():
    """At 2^31 bodies (2^21 blocks) k reaches 2.2e12, where the double root
    can be one off: the kernel's corrections give the exact map."""
    rng = np.random.default_rng(0)
    ks = list(rng.integers(0, 1 << 41, size=2000)) + [
        a * (a + 1) // 2 + d for a in (1 << 20, (1 << 21) - 1, 123457)
        for d in (-1, 0, 1)]
    for k in map(int, ks):
        assert _tri_pair_as_the_kernel(k) == cb._tri_pair(k), k


# --- (b) the constants the wrappers rely on ----------------------------------

def _constant(text, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return m.group(1).strip()


def test_block_constants_match_the_sources():
    engine = (CSRC / "newton3_tile.cuh").read_text()
    warps = int(_constant(engine, "kN3Warps"))
    r = int(re.match(r"(\d+)", _constant(engine, "kN3R")).group(1))
    assert _constant(engine, "kN3Threads") == "32 * kN3Warps"
    assert _constant(engine, "kN3Block") == "kN3Threads * kN3R"
    assert cb.SYM_BLOCK == 32 * warps * r
    assert int(_constant((CSRC / "pair_law.cuh").read_text(),
                         "kChain")) == 32
    # K1's block size comes back through the C ABI from the engine.
    assert "return nbody::kN3Block;" in (CSRC / "symmetric.cu").read_text()
    # Shared memory of the 3D instance: sources + one slot set a warp.
    smem3 = cb.SYM_BLOCK * 16 + warps * 3 * cb.SYM_BLOCK * 4
    assert smem3 <= 227 * 1024


@pytest.mark.parametrize("name,source", [
    ("nbody_symmetric_forces", "symmetric.cu"),
    ("nbody_symmetric_block", "symmetric.cu"),
    ("nbody_sym_tile", "sym_tile.cu")])
def test_c_abi_arity_matches_the_ctypes_signatures(name, source):
    text = (CSRC / source).read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    assert m, name
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(cuda_build._SIGNATURES[name][0])


# --- (c) K1's plain version at the kernel's block ----------------------------

def _bodies(n, dim, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 1e7, size=(n, dim)).astype(np.float32)
    mass = rng.uniform(1.0, 1e8, size=n).astype(np.float32)
    return pos, mass


def _coincident_across_blocks(n, dim, seed):
    """softening-0 inputs: body 3 coincides with body n - 2, in another
    block, and bodies 0 and 1 coincide inside the first."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(10.0, 20.0, size=(n, dim)).astype(np.float32)
    pos[1] = pos[0]
    pos[n - 2] = pos[3]
    return pos, np.ones(n, np.float32)


# (N, dim, softening): N just over one and two blocks of 1024, ragged.
@pytest.mark.parametrize("n,dim,softening", [
    (1025, 2, 1e-6), (1100, 3, 0.0), (2049, 3, 1e-6), (2100, 2, 0.0)])
def test_symmetric_plain_at_kernel_block_matches_pallas(n, dim, softening):
    """Tolerances of test_torch_cuda_brute.py: 1e-5 against the Pallas
    kernel, 1e-4 against the f64 oracle (scale-normalized)."""
    jnp = pytest.importorskip("jax.numpy")
    from nbody_tpu.config import GravityConfig as JGravity
    from nbody_tpu.ops.brute_force import brute_force_direct
    from nbody_tpu.ops.pallas_brute import brute_force_pallas
    if softening == 0.0:
        pos, mass = _coincident_across_blocks(n, dim, seed=n)
        cfg = {"G": 1.0, "softening": 0.0}
    else:
        pos, mass = _bodies(n, dim, seed=n)
        cfg = {"softening": softening}
    want = brute_force_pallas(jnp.asarray(pos), jnp.asarray(mass),
                              JGravity(**cfg), block_t=cb.SYM_BLOCK,
                              mode="symmetric", s_sub=cb.SYM_BLOCK,
                              interpret=True)
    want64 = np.asarray(brute_force_direct(
        jnp.asarray(pos, jnp.float64), jnp.asarray(mass, jnp.float64),
        JGravity(**cfg)))
    have = cb.symmetric_forces_plain(torch.from_numpy(pos),
                                     torch.from_numpy(mass), TGravity(**cfg))
    assert have.dtype == torch.float32 and have.shape == (n, dim)
    assert bool(torch.isfinite(have).all())
    assert float(scale_normalized_error(have, np.asarray(want))) < 1e-5
    assert float(scale_normalized_error(have, want64)) < 1e-4


def test_symmetric_plain_applies_masses_after_the_sums():
    """Both sides of a block pair carry each body's own mass once: the f64
    plain version equals the one-sided f64 forces."""
    pos, mass = _bodies(2100, 3, seed=4)
    p, m = torch.from_numpy(pos).double(), torch.from_numpy(mass).double()
    have = cb.symmetric_forces_plain(p, m, TGravity(), guard=False)
    want = m[:, None] * cb.pairwise_accel_plain(p, p, m, 1e-6, guard=False)
    np.testing.assert_allclose(have.numpy(), (TGravity().G * want).numpy(),
                               rtol=1e-10, atol=1e-10 * float(want.abs().max())
                               * TGravity().G)


# --- (d) the kernels on the card --------------------------------------------

# N < block, N = block ± 1, and a ragged N over several blocks.
K1_SHAPES = [(700, 2), (1023, 3), (1025, 2), (3001, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,dim", K1_SHAPES)
@pytest.mark.parametrize("softening", [0.0, 1e-6])
def test_k1_kernel_matches_plain_on_card(cuda_device, n, dim, softening):
    """K1 against its f64 plain version: 1e-4 scale-normalized (the JAX
    kernel tests' bound), one launch a call."""
    if softening == 0.0:
        pos, mass = _coincident_across_blocks(n, dim, seed=n)
        cfg = TGravity(G=1.0, softening=0.0)
    else:
        pos, mass = _bodies(n, dim, seed=n)
        cfg = TGravity(softening=softening)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    before = cuda_build.LAUNCHES["symmetric"]
    have = cb.brute_force_cuda(p.to(cuda_device), m.to(cuda_device), cfg,
                               mode="symmetric")
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["symmetric"] == before + 1
    want = cb.symmetric_forces_plain(p.double(), m.double(), cfg)
    assert bool(torch.isfinite(have).all())
    err = float(scale_normalized_error(have.cpu().double(), want))
    assert err < 1e-4, err


# (targets, sources, dim): < block, block ± 1, ragged over several blocks.
K3_SHAPES = [(700, 300, 2), (1023, 1025, 3), (1025, 1023, 2),
             (2500, 3001, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,dim", K3_SHAPES)
@pytest.mark.parametrize("softening", [0.0, 1e-6])
def test_k3_kernel_matches_plain_on_card(cuda_device, t, s, dim, softening):
    """K3's two outputs against its f64 plain version, each within 1e-4
    scale-normalized, one launch a call."""
    if softening == 0.0:
        pos, mass = _coincident_across_blocks(t + s, dim, seed=t)
        pos[t] = pos[0]  # target 0 coincides with source 0
    else:
        pos, mass = _bodies(t + s, dim, seed=t)
    x = [torch.from_numpy(a) for a in (pos[:t], mass[:t], pos[t:], mass[t:])]
    before = cuda_build.LAUNCHES["sym_tile"]
    have = cb.sym_tile_cuda(*(a.to(cuda_device) for a in x), softening)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["sym_tile"] == before + 1
    want = cb.sym_tile_plain(*(a.double() for a in x), softening)
    for h, w in zip(have, want):
        assert bool(torch.isfinite(h).all())
        err = float(scale_normalized_error(h.cpu().double(), w))
        assert err < 1e-4, err


@pytest.mark.cuda
def test_k3_is_one_launch_at_any_tile_size(cuda_device):
    """A 600,000 x 600,000 2D tile, both sides above the JAX package's
    524,288-row chunk, is one K3 launch. On sampled rows of each side, the
    old chunk's edges among them, both outputs are within 1e-4
    scale-normalized of the f64 plain version on the card, and they equal
    two calls on the halves of the sources (acc_t their sum, part_s their
    concatenation) within the same bound."""
    t = s = 600_000
    pos, mass = _bodies(t + s, 2, seed=21)
    tp, tm, sp, sm = (torch.from_numpy(a).to(cuda_device)
                      for a in (pos[:t], mass[:t], pos[t:], mass[t:]))
    before = cuda_build.LAUNCHES["sym_tile"]
    acc_t, part_s = cb.sym_tile_cuda(tp, tm, sp, sm, 1e-6)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["sym_tile"] == before + 1
    gen = torch.Generator().manual_seed(21)
    rows = torch.cat([torch.tensor([0, 524_287, 524_288, t - 1]),
                      torch.randperm(t, generator=gen)[:508]]).to(cuda_device)
    tp64, tm64, sp64, sm64 = (a.double() for a in (tp, tm, sp, sm))
    want_t = cb.sym_tile_plain(tp64[rows], tm64[rows], sp64, sm64, 1e-6)[0]
    want_s = cb.sym_tile_plain(sp64[rows], sm64[rows], tp64, tm64, 1e-6)[0]
    for have, want in ((acc_t[rows], want_t), (part_s[rows], want_s)):
        assert bool(torch.isfinite(have).all())
        err = float(scale_normalized_error(have.double(), want))
        assert err < 1e-4, err
    h = s // 2
    a0, p0 = cb.sym_tile_cuda(tp, tm, sp[:h], sm[:h], 1e-6)
    a1, p1 = cb.sym_tile_cuda(tp, tm, sp[h:], sm[h:], 1e-6)
    for have, want in ((acc_t, a0.double() + a1.double()),
                       (part_s, torch.cat([p0, p1]).double())):
        err = float(scale_normalized_error(have.double(), want))
        assert err < 1e-4, err


# --- the build reports read on the card --------------------------------------

_LOG = """== symmetric.cu
ptxas info    : Compiling entry function '_ZN5nbody14newton3_kernelILi2ELb0ELb1EEEvPK6float4S3_PdS4_iiixf' for 'sm_90a'
ptxas info    : Function properties for _ZN5nbody14newton3_kernelILi2ELb0ELb1EEEvPK6float4S3_PdS4_iiixf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 123 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5nbody15diagonal_kernelILi3ELb1EEEvPK6float4Pdxf' for 'sm_90a'
ptxas info    : Function properties for _ZN5nbody15diagonal_kernelILi3ELb1EEEvPK6float4Pdxf
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 16384 bytes smem
"""


def test_ptxas_report_and_kernel_labels():
    rep = cuda_build.ptxas_report(_LOG)
    labels = {cuda_build.kernel_label(k): v for k, v in rep.items()}
    assert labels == {
        "newton3_kernel<2,0,1>": {"spill_stores": 0, "spill_loads": 0,
                                  "registers": 123, "smem": 0},
        "diagonal_kernel<3,1>": {"spill_stores": 8, "spill_loads": 4,
                                 "registers": 127, "smem": 16384}}


@pytest.mark.parametrize("mangled,label", [
    ("_ZN5nbody14newton3_kernelILi3ELb1ELb0EEEvPK6float4S3_PdS4_iiixf",
     "newton3_kernel<3,1,0>"),
    ("_ZN5nbody15diagonal_kernelILi2ELb0EEEvPK6float4Pdxf",
     "diagonal_kernel<2,0>"),
    ("_ZN5nbody15p2p_leaf_kernelILi3EEEvPK6float4S3_PS1_iif",
     "p2p_leaf_kernel<3>"),
    ("_ZN5nbody18fused_steps_kernelILi2ELb1ELi2ELb0EEEvP6float4S2_iifff",
     "fused_steps_kernel<2,1,2,0>"),
    ("_ZN5nbody14rate_probe_f32ILi6EEEvPfiiff", "rate_probe_f32<6>"),
    ("nbody_error_string", "nbody_error_string")])
def test_kernel_label_reads_template_arguments(mangled, label):
    """chip_smoke.py names the ptxas report's instances by these labels;
    a name without template arguments comes back as it is."""
    assert cuda_build.kernel_label(mangled) == label


def test_pair_laws_share_one_rsqrt():
    """Every pair law of pair_law.cuh takes the ftz MUFU.RSQ and nothing
    selects another rsqrt (the two give the same u^3 for every input)."""
    text = (CSRC / "pair_law.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "rsqrtf(" not in code
    assert code.count("rsqrt_ftz(") == 3  # its definition and two laws
    assert re.search(r"template <int DIM, bool GUARD>\s*__device__"
                     r"[^\n]*\n?\s*float pair_u3\(", code)
    for src in CSRC.glob("*.cu*"):
        assert not re.search(r"pair_u3<[^>]*,[^>]*,[^>]*>",
                             src.read_text()), src.name
