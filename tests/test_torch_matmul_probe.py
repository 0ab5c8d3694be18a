"""P's skinny product (csrc/rate_probe.cu nbody_matmul_probe, wrapped by
nbody_tpu_torch.tools.microbench.matmul_probe): its tilings.

On the CPU: the wide kernel's CTA tiles, S-slices (ranks of a tile),
k-groups and 8-column micro-tiles, and the narrow kernel's 4 x 4 CTAs over
S in stretches, with their constants read from the source (no nvcc here),
cover every output and every reduction index exactly once per repeat; an
emulation of either tiling with its fixed-order sums (k-groups, then the
slices' ranks; warps) matches ``matmul_probe_plain``. The
``cuda``-marked test runs the kernel against its f64 plain version and
skips without a card; it needs no JAX (``pytest --noconftest -m cuda``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_tpu_torch.tools import microbench as mb
from nbody_tpu_torch.utils import cuda_build
from nbody_tpu_torch.utils.accuracy import scale_normalized_error

SOURCE = (Path(cuda_build.__file__).resolve().parent.parent / "csrc"
          / "rate_probe.cu").read_text()


def _c(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


BM, BN, BK, SLICES = _c("kMatBM"), _c("kMatBN"), _c("kMatBK"), _c("kMatSlices")
THREADS, TM = _c("kMatThreads"), _c("kMatTM")
TY, TX = BM // TM, BN // 8
KG = THREADS // (TX * TY)
KPER, ROW_STRIDE = BK // KG, BM * 4 // TM
NARROW_MAX_K, NR, NC = _c("kMatNarrowMaxK"), _c("kMatNR"), _c("kMatNC")
NS, NTHREADS = _c("kMatNS"), _c("kMatNThreads")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe kernels are built by nvcc "
                    "and run only on the card")
    return torch.device("cuda", 0)


def _wide_ctas(m, s, kk):
    """Per CTA (bx, by, rank): each thread's rows [T, TM], columns [T, 8]
    and reduction indices [T, nk], in the kernel's thread order."""
    tid = np.arange(THREADS)
    tx, ty, kg = tid % TX, (tid // TX) % TY, tid // (TX * TY)
    i = np.arange(TM)
    rows0 = (i // 4) * ROW_STRIDE + ty[:, None] * 4 + i % 4
    cols0 = (np.arange(2)[:, None] * (BN // 2) + tx[:, None, None] * 4
             + np.arange(4)).reshape(THREADS, 8)
    for bx in range(-(-m // BM)):
        for by in range(-(-kk // BN)):
            for rank in range(SLICES):
                k0s = np.arange(rank * BK, s, SLICES * BK)
                ks = (k0s[None, :, None] + kg[:, None, None] * KPER
                      + np.arange(KPER)).reshape(THREADS, -1)
                yield (bx, by, rank), (bx * BM + rows0, by * BN + cols0, ks,
                                       kg)


def _narrow_ctas(m, s, kk):
    tid = np.arange(NTHREADS)
    for bx in range(-(-m // NR)):
        for by in range(-(-kk // NC)):
            k0s = np.arange(0, s, NS)
            ks = (k0s[None, :, None] + tid[:, None, None]
                  + np.arange(NS // NTHREADS) * NTHREADS).reshape(NTHREADS,
                                                                 -1)
            yield (bx, by), (np.tile(bx * NR + np.arange(NR), (NTHREADS, 1)),
                             np.tile(by * NC + np.arange(NC), (NTHREADS, 1)),
                             ks, tid // 32)


def _ctas(m, s, kk):
    return _narrow_ctas(m, s, kk) if kk <= NARROW_MAX_K else \
        _wide_ctas(m, s, kk)


@pytest.mark.parametrize("m,s,kk", [(512, 2048, 4), (6, 2100, 7),
                                    (32, 2048, 128), (33, 2348, 130)])
def test_tiles_cover_each_output_and_reduction_index_once(m, s, kk):
    """Over all CTAs and threads of one launch, each (row, column, k) with
    row < M, column < K, k < S is one thread's FMA exactly once per repeat;
    every other index a thread touches is past an edge (zero-filled)."""
    count = np.zeros(m * kk * s, np.int64)
    for _, (rows, cols, ks, _) in _ctas(m, s, kk):
        r = rows[:, :, None, None]
        c = cols[:, None, :, None]
        k = ks[:, None, None, :]
        live = (r < m) & (c < kk) & (k < s)
        flat = ((r * kk + c) * s + k)[live]
        count += np.bincount(flat, minlength=count.size)
    assert (count == 1).all()


def _emulate(a, b, reps):
    """The kernel's sums in f64: per thread group its share of each repeat,
    then the fixed-order reductions (wide: k-groups, then the slices'
    ranks; narrow: lanes, then warps; all sums of disjoint parts)."""
    m, s = a.shape
    kk = b.shape[1]
    out = torch.zeros((m, kk), dtype=torch.float64)
    parts = {}
    for key, (rows, cols, ks, group) in _ctas(m, s, kk):
        for g in np.unique(group):
            sel = group == g
            r, c = np.unique(rows[sel]), np.unique(cols[sel])
            kv = np.unique(ks[sel])
            r, c, kv = r[r < m], c[c < kk], kv[kv < s]
            acc = torch.zeros((len(r), len(c)), dtype=torch.float64)
            for _ in range(reps):
                acc = acc + a[r][:, kv] @ b[kv][:, c]
            tile = key[:2]
            part = parts.setdefault(tile, torch.zeros_like(out))
            part[np.ix_(r, c)] += acc
    for part in parts.values():
        out += part
    return out


@pytest.mark.parametrize("m,s,kk", [(512, 2048, 4), (512, 2048, 128),
                                    (37, 2500, 7), (37, 2500, 150)])
def test_tiling_emulation_matches_plain(m, s, kk):
    rng = np.random.default_rng(m + s + kk)
    a = torch.from_numpy(rng.uniform(0, 1, (m, s)))
    b = torch.from_numpy(rng.uniform(0, 1, (s, kk)))
    want = mb.matmul_probe_plain(a, b, 3)
    have = _emulate(a, b, 3)
    assert float(scale_normalized_error(have, want)) < 1e-12


def test_tilings_fill_the_card_at_the_probe_shapes():
    """At (512, 2048) @ (2048, K) both kernels launch 128 CTAs, one wave of
    one an SM on the card's 132, and their tiles fit shared memory."""
    m, s = mb.MATMUL_SHAPE
    assert mb.MATMUL_KS == (4, 128)
    assert 4 <= NARROW_MAX_K < 128
    assert sum(1 for _ in _narrow_ctas(m, s, 4)) == 128
    assert sum(1 for _ in _wide_ctas(m, s, 128)) == 128
    assert SLICES * BK == s  # one slice a CTA
    assert (BK * BM + BK * BN) * 4 <= 227 * 1024
    assert NS * (NR + NC) * 4 <= 227 * 1024 and NS == s


@pytest.mark.cuda
@pytest.mark.parametrize("m,s,kk", [(512, 2048, 4), (512, 2048, 128),
                                    (37, 2500, 7), (37, 2500, 150)])
def test_matmul_probe_matches_plain_on_card(cuda_device, m, s, kk):
    """The kernel against its f64 plain version over 64 repeats: each
    output is an fp32 chain of up to 64 x 32 FMAs, whose rounding (~2e-6
    relative at U(0, 1) inputs) stays under 2e-5 (chip_smoke.py
    MATMUL_TOL). A second launch gives the same bits (fixed order)."""
    gen = torch.Generator().manual_seed(m * kk)
    a = torch.rand((m, s), generator=gen)
    b = torch.rand((s, kk), generator=gen)
    before = cuda_build.LAUNCHES["matmul_probe"]
    have = mb.matmul_probe(a.to(cuda_device), b.to(cuda_device), 64)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["matmul_probe"] == before + 1
    assert torch.equal(have, mb.matmul_probe(a.to(cuda_device),
                                             b.to(cuda_device), 64))
    want = mb.matmul_probe_plain(a.double(), b.double(), 64)
    err = float(scale_normalized_error(have.cpu().double(), want))
    assert err < 2e-5, err
