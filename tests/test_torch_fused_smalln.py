"""K4's plain version (nbody_tpu_torch.ops.cuda_brute.fused_smalln_*)
against the JAX Pallas fused small-N integrator, run in interpret mode, and
a pure-torch emulation of K4's cluster walk (csrc/fused_steps.cu) against
both.

K4 itself runs only on the card (``chip_smoke.py``,
``tests/test_torch_fused_cuda.py``); here the wrapper gets CPU tensors and
takes its plain version. The emulation takes the kernel's constants from
its source (no nvcc here): the cluster sizes C, the thread budget, the
target lanes that set R, the largest split count S and kChain. It walks
the launch as the kernel does (each CTA's slice of targets, its lanes and
splits, each split's whole chains) and sums as the kernel does: fp32
chains of kChain sources into an fp64 total a split, the splits' totals
added in split order, and one force evaluation a leapfrog step, carried
into the next.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.pallas_brute import fused_smalln_simulate as j_fused
from nbody_tpu_torch.config import G_DEFAULT, SOFTENING
from nbody_tpu_torch.ops import cuda_brute as cb
from nbody_tpu_torch.utils import cuda_build

torch.set_num_threads(2)

_CSRC = Path(cuda_build.SOURCE_DIR)
SOURCE = (_CSRC / "fused_steps.cu").read_text()
PAIR_LAW = (_CSRC / "pair_law.cuh").read_text()


def _constant(name, text=SOURCE):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


CLUSTERS = (_constant("kFusedCluster"), _constant("kFusedPortableCluster"))
THREADS = _constant("kFusedThreads")
MAX_GROUP = _constant("kFusedMaxGroup")
MAX_SPLITS = _constant("kFusedMaxSplits")
FUSED_MAX = _constant("kFusedMax")
CHAIN = _constant("kChain", PAIR_LAW)
PAD_POS = 2.0e9  # pair_law.cuh kPadPos, a zero-mass body
SMEM_LIMIT = 232_448  # the dynamic shared memory one H100 CTA may use


def _plan(n, c):
    """fused_plan: (T targets a CTA, R targets a lane, G lanes, S splits)."""
    nch = -(-n // CHAIN)
    t = -(-n // c)
    r = -(-t // MAX_GROUP)
    g = -(-(-(-t // r)) // 32) * 32
    s = min(THREADS // r // g, MAX_SPLITS, nch)
    return t, r, g, s


def _split_chains(nch, s):
    """Split q's whole chains [q*nch//s, (q+1)*nch//s)."""
    return [(q * nch // s, (q + 1) * nch // s) for q in range(s)]


def _walk(n, c):
    """The launch's threads: one row per (CTA, thread, target row) with
    its target, whether it owns it, its split and the split's chains."""
    t, r, g, s = _plan(n, c)
    tid = np.arange(g * s)
    split, lane = tid // g, tid % g
    rows = []
    for rank in range(c):
        for row in range(r):
            j = lane + row * g
            tgt = rank * t + j
            rows.append(np.stack([tgt, (j < t) & (tgt < n), split], 1))
    return np.concatenate(rows), _split_chains(-(-n // CHAIN), s)


def _accel(x, m, soft, guard, g, c):
    """One force evaluation as the kernel sums it: [n, D] fp32, scaled by
    g. fmaf is an f64 product and sum rounded once to fp32."""
    n, dim = x.shape
    n_src = -(-n // CHAIN) * CHAIN
    src = torch.full((n_src, dim), PAD_POS, dtype=torch.float32)
    src[:n] = x
    ms = torch.zeros(n_src, dtype=torch.float32)
    ms[:n] = m
    soft2 = torch.tensor(soft, dtype=torch.float32) ** 2

    def fma(a, b, acc):
        return (a.double() * b.double() + acc.double()).float()

    _, _, _, s = _plan(n, c)
    total = None
    for c0, c1 in _split_chains(n_src // CHAIN, s):
        part = torch.zeros((n, dim), dtype=torch.float64)
        for ch in range(c0, c1):
            b = torch.zeros((n, dim), dtype=torch.float32)
            for k in range(ch * CHAIN, (ch + 1) * CHAIN):
                d = src[k] - x
                d2 = soft2.expand(n)
                for ax in range(dim):
                    d2 = fma(d[:, ax], d[:, ax], d2)
                u = torch.rsqrt(d2)
                u3 = u * u * u
                if guard:
                    u3 = torch.where(d2 - soft2 < 1e-10, 0.0, u3)
                w = u3 * ms[k]
                b = fma(w[:, None], d, b)
            part = part + b.double()
        total = part if total is None else total + part
    return total.float() * g


def _emulate(pos, vel, mass, *, dt, num_steps, g, softening, integrator,
             cluster):
    """K4 on the CPU: the kernel's sums and its one sweep a step."""
    guard = float(softening) == 0.0
    x, v, m = (torch.as_tensor(a, dtype=torch.float32)
               for a in (pos, vel, mass))
    dt32 = torch.tensor(dt, dtype=torch.float32)
    half = 0.5 * dt32

    def accel(p):
        return _accel(p, m, softening, guard, g, cluster)

    if integrator == "leapfrog" and num_steps > 0:
        a = accel(x)
    for _ in range(num_steps):
        if integrator == "euler":
            v = v + accel(x) * dt32
            x = x + v * dt32
        else:
            v = v + a * half
            x = x + v * dt32
            a = accel(x)  # carried into the next step's first kick
            v = v + a * half
    return x, v


def _reference_units(n, dim, seed):
    """The reference distribution (utils.h:113-115), G = 4.471e-21."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, 1e7, size=(n, dim)).astype(np.float32)
    vel = rng.uniform(-10.0, 10.0, size=(n, dim)).astype(np.float32)
    mass = rng.uniform(1.0, 1e8, size=n).astype(np.float32)
    return (pos, vel, mass), {"g": G_DEFAULT, "softening": SOFTENING,
                              "dt": 1e-6, "num_steps": 8}


def _plummer_units(n, dim, seed):
    """A warm cluster in G = 1 units at softening 0.1: bodies move."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, dim)).astype(np.float32)
    vel = (0.3 * rng.normal(size=(n, dim))).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    return (pos, vel, mass), {"g": 1.0, "softening": 0.1, "dt": 1e-3,
                              "num_steps": 16}


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("make,n,dim,moves", [
    (_reference_units, 300, 2, False), (_plummer_units, 200, 3, True)])
def test_fused_plain_matches_pallas(make, n, dim, moves, integrator):
    """Both run the same per-step operation order in fp32 and differ only in
    the order of each force sum, which moves an acceleration by a few fp32
    ulps. Over 16 steps of dt 1e-3 that shifts velocities and positions by
    ~1e-8 of their largest value (measured on the CPU); the bound is 1e-6
    of it. In reference units the steps do not move the state at fp32
    resolution at all, as the JAX package's own test records."""
    arrays, kw = make(n, dim, seed=n)
    want = j_fused(*map(jnp.asarray, arrays), integrator=integrator,
                   interpret=True, **kw)
    have = cb.fused_smalln_simulate(*map(torch.from_numpy, arrays),
                                    integrator=integrator, **kw)
    moved = False
    for h, w, start in zip(have, want, arrays):
        w = np.asarray(w)
        assert h.dtype == torch.float32 and h.shape == (n, dim)
        np.testing.assert_allclose(h.numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()))
        moved |= not np.array_equal(w, start)
    assert moved == moves


def test_fused_wrapper_is_plain_on_cpu_and_launches_nothing():
    arrays, kw = _plummer_units(64, 2, seed=1)
    tensors = list(map(torch.from_numpy, arrays))
    before = dict(cb.LAUNCHES)
    have = cb.fused_smalln_simulate(*tensors, integrator="leapfrog", **kw)
    want = cb.fused_smalln_plain(*tensors, integrator="leapfrog", **kw)
    assert cb.LAUNCHES == before
    for h, w in zip(have, want):
        assert torch.equal(h, w)


def test_fused_guard_default_keeps_coincident_bodies_finite():
    """softening == 0 turns the pair guard on (the JAX default)."""
    pos = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 0.0]], np.float32)
    vel = np.zeros_like(pos)
    mass = np.ones(3, np.float32)
    kw = {"dt": 1e-3, "num_steps": 4, "g": 1.0, "softening": 0.0}
    want = j_fused(*map(jnp.asarray, (pos, vel, mass)), interpret=True, **kw)
    have = cb.fused_smalln_simulate(*map(torch.from_numpy, (pos, vel, mass)),
                                    **kw)
    for h, w in zip(have, want):
        assert bool(torch.isfinite(h).all())
        np.testing.assert_allclose(h.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)


def test_fused_rejects_big_n_and_bad_integrator():
    n = cb.FUSED_SMALLN_MAX + 1
    with pytest.raises(ValueError, match="fused_smalln"):
        cb.fused_smalln_simulate(torch.zeros((n, 2)), torch.zeros((n, 2)),
                                 torch.ones(n), dt=1e-6, num_steps=1)
    with pytest.raises(ValueError, match="integrator"):
        cb.fused_smalln_simulate(torch.zeros((4, 2)), torch.zeros((4, 2)),
                                 torch.ones(4), dt=1e-6, num_steps=1,
                                 integrator="rk4")


def test_cluster_sizes_are_the_sources_two_and_others_are_refused():
    """set_fused_cluster_size takes the two sizes fused_steps.cu builds (and
    0, the card's choice) and refuses any other before it reaches the C
    side, which refuses it too."""
    assert cb.FUSED_CLUSTER_SIZES == (0, *CLUSTERS)
    assert re.search(r"c != 0 && c != kFusedCluster && "
                     r"c != kFusedPortableCluster", SOURCE)
    for bad in (1, 4, 32, -8):
        with pytest.raises(ValueError, match="cluster size"):
            cb.set_fused_cluster_size(bad)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 1025, 2047, 2048])
def test_cluster_walk_covers_every_target_and_chain_once(n, cluster):
    """Every target is owned by one lane of split 0 in one CTA, and the S
    splits of its lane sweep every source chain once between them. The
    launch fits: warps lie in one split, threads within the bound, the
    split totals and both buffers within the kernel's shared memory."""
    t, r, g, s = _plan(n, cluster)
    assert g % 32 == 0 and g * s * r <= THREADS and s <= MAX_SPLITS
    assert t * cluster >= n and n <= FUSED_MAX
    threads, chains = _walk(n, cluster)
    nch = -(-n // CHAIN)
    assert [c for c0, c1 in chains for c in range(c0, c1)] == list(range(nch))
    owned = threads[threads[:, 1] == 1]
    assert np.array_equal(np.sort(owned[owned[:, 2] == 0, 0]), np.arange(n))
    counts = np.zeros((n, nch), np.int64)
    for tgt, _, split in owned:
        c0, c1 = chains[split]
        counts[tgt, c0:c1] += 1
    assert (counts == 1).all()
    smem = 2 * 16 * nch * CHAIN + 8 * (s - 1) * 3 * g * r
    bound = 2 * 16 * FUSED_MAX + 8 * THREADS * 3
    assert smem <= bound <= SMEM_LIMIT


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("make,n,dim,moves", [
    (_reference_units, 300, 2, False), (_plummer_units, 200, 3, True)])
def test_cluster_emulation_matches_plain_and_pallas(make, n, dim, moves,
                                                    integrator, cluster):
    """The emulated kernel against the plain version and the JAX kernel in
    interpret mode, at test_fused_plain_matches_pallas's bound (1e-6 of the
    largest value): the three differ only in the order of each force sum.
    In reference units nothing moves at fp32 resolution, so all three are
    the same bits."""
    arrays, kw = make(n, dim, seed=n)
    have = _emulate(*arrays, integrator=integrator, cluster=cluster, **kw)
    plain = cb.fused_smalln_plain(*map(torch.from_numpy, arrays),
                                  integrator=integrator, **kw)
    pallas = j_fused(*map(jnp.asarray, arrays), integrator=integrator,
                     interpret=True, **kw)
    for h, p, w, start in zip(have, plain, pallas, arrays):
        w = np.asarray(w)
        assert h.dtype == torch.float32 and h.shape == (n, dim)
        for want in (p.numpy(), w):
            np.testing.assert_allclose(h.numpy(), want, rtol=0,
                                       atol=1e-6 * float(np.abs(w).max()))
            if not moves:
                assert np.array_equal(h.numpy(), want)
        assert np.array_equal(h.numpy(), start) == (not moves)
