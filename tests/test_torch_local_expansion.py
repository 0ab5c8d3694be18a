"""Local expansions and the hierarchical far field of the Barnes-Hut tier
(nbody_tpu_torch.ops.local_expansion, .hier_far) against the JAX package.

The closed forms are held term by term against ``nbody_tpu.ops.
local_expansion`` (which its own tests pin against ``jax.jacfwd``), in f64
to 1e-12 relative; the downward sweep against ``hier_far_coeffs`` on one
tree carried into the port by ``grid_tree_from_numpy``, to 1e-12.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import grid_tree as jg
from nbody_tpu.ops import hier_far as jh
from nbody_tpu.ops import local_expansion as jl
from nbody_tpu_torch.config import GravityConfig as TGravity
from nbody_tpu_torch.ops import grid_tree as tg
from nbody_tpu_torch.ops import hier_far as th
from nbody_tpu_torch.ops import local_expansion as tl
from nbody_tpu_torch.ops.brute_force import brute_force_direct
from nbody_tpu_torch.utils.accuracy import scale_normalized_error


def _close(have, want, rtol=1e-12):
    want = np.asarray(want)
    if want.size == 0:
        assert np.asarray(have).shape == want.shape
        return
    np.testing.assert_allclose(np.asarray(have), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-300))


def _sources(dim, b, k, seed, quad=True):
    """Cells at distance ~10 from centres in a unit box, with COM-centred
    second moments Σ m (x−c)(x−c)ᵀ of a few random bodies each."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1, 1, (b, dim))
    com = center[:, None, :] + rng.uniform(5, 15, (b, k, dim)) \
        * rng.choice([-1.0, 1.0], (b, k, dim))
    mass = rng.uniform(0.5, 2.0, (b, k))
    mass[:, ::4] = 0.0  # masked cells carry mass 0 (and S 0)
    S = None
    if quad:
        pts = rng.normal(0, 0.5, (b, k, 5, dim))
        w = rng.uniform(0.1, 1.0, (b, k, 5))
        pts -= (w[..., None] * pts).sum(2, keepdims=True) / \
            w.sum(-1)[..., None, None]
        S = np.stack([(w * pts[..., a] * pts[..., c]).sum(-1)
                      for a, c in tg._quad_pairs(dim)], axis=-1)
        S[:, ::4] = 0.0
    return center, com, mass, S


def _carried(jtree):
    return tg.grid_tree_from_numpy(
        {f.name: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                  else v if isinstance(v, int) else np.asarray(v))
         for f in dataclasses.fields(jtree)
         for v in [getattr(jtree, f.name)]}, device="cpu")


def test_static_tables_and_counts_match_jax():
    assert tl.LOCAL_RATIO_DEFAULT == jl.LOCAL_RATIO_DEFAULT
    for dim in (2, 3):
        assert tl.num_coeffs(dim) == jl.num_coeffs(dim)
        assert tl.num_coeffs3(dim) == jl.num_coeffs3(dim)
        assert tl._h_triples(dim) == jl._h_triples(dim)
        assert tl._k_quads(dim) == jl._k_quads(dim)
        for k, L, l, ratio, leaf in itertools.product(
                (1, 2, 3), (3, 6, 9), range(2, 10), (0.1, 0.18, 0.3),
                (False, True)):
            assert tl.ring_level_is_local(dim, k, L, l, ratio, leaf) == \
                jl.ring_level_is_local(dim, k, L, l, ratio, leaf)
        for pm in range(1 << dim):
            np.testing.assert_array_equal(th._par_vec(pm, dim),
                                          jh._par_vec(pm, dim))
        for k in (1, 2, 3, 4):
            for c_min in range(k + 1, k + 4):
                have = th._parity_shell_sel(dim, k, c_min)
                want = jh._parity_shell_sel(dim, k, c_min)
                for h, w in zip(have[0] + have[1], want[0] + want[1]):
                    np.testing.assert_array_equal(h, w)
                for h, w in zip(have[2], want[2]):
                    np.testing.assert_array_equal(h, w)
            for h, w in zip(th.leaf_defer_tables(dim, k),
                            jh.leaf_defer_tables(dim, k)):
                np.testing.assert_array_equal(h, w)


@pytest.mark.parametrize("multipole", ["mono", "quad"])
@pytest.mark.parametrize("softening", [0.0, 0.3])
def test_local_coeffs_match_jax(dim, multipole, softening):
    center, com, mass, S = _sources(dim, 6, 20, seed=dim,
                                    quad=multipole == "quad")
    for order3 in (False, True):
        want = jl.local_coeffs(jnp.asarray(center), jnp.asarray(com),
                               jnp.asarray(mass),
                               None if S is None else jnp.asarray(S),
                               softening=softening, order3=order3)
        have = tl.local_coeffs(torch.from_numpy(center),
                               torch.from_numpy(com), torch.from_numpy(mass),
                               None if S is None else torch.from_numpy(S),
                               softening=softening, order3=order3)
        assert len(have) == len(want) == (4 if order3 else 3)
        for h, w in zip(have, want):
            _close(h.numpy(), w)


def test_local_coeffs_guard_empty_cells():
    """A cell at the expansion centre (r² < 1e-10) adds nothing, as in
    JAX's guard."""
    center = torch.zeros((1, 3), dtype=torch.float64)
    com = torch.zeros((1, 2, 3), dtype=torch.float64)
    com[0, 1] = torch.tensor([3.0, 0.0, 0.0])
    mass = torch.ones((1, 2), dtype=torch.float64)
    a0, J, H, K = tl.local_coeffs(center, com, mass, order3=True)
    b0, *_ = tl.local_coeffs(center, com[:, 1:], mass[:, 1:], order3=True)
    assert torch.equal(a0, b0)
    assert bool(torch.isfinite(J).all() & torch.isfinite(K).all())


def test_eval_and_shift_local_match_jax(dim):
    center, com, mass, S = _sources(dim, 5, 12, seed=10 + dim)
    coeffs = jl.local_coeffs(jnp.asarray(center), jnp.asarray(com),
                             jnp.asarray(mass), jnp.asarray(S), order3=True)
    tco = tuple(torch.from_numpy(np.array(c)) for c in coeffs)
    rho = np.random.default_rng(3).uniform(-0.5, 0.5, (5, 7, dim))
    for k_term in (False, True):
        want = jl.eval_local(jnp.asarray(rho), *coeffs[:3],
                             coeffs[3] if k_term else None)
        have = tl.eval_local(torch.from_numpy(rho), *tco[:3],
                             tco[3] if k_term else None)
        _close(have.numpy(), want)
    for delta in (np.array([0.25, -0.5, 0.125][:dim]),
                  np.random.default_rng(4).uniform(-1, 1, (5, dim))):
        want = jl.shift_local(*coeffs, jnp.asarray(delta))
        have = tl.shift_local(*tco, torch.from_numpy(delta))
        for h, w in zip(have, want):
            _close(h.numpy(), w)
    # The shift is exact: the order-3 polynomial re-centred, as in JAX's
    # test (tests/test_local_expansion.py:314-334).
    delta = torch.tensor([0.3, -0.2, 0.1][:dim], dtype=torch.float64)
    direct = tl.eval_local(torch.from_numpy(rho), *tco)
    via = tl.eval_local(torch.from_numpy(rho) - delta,
                        *tl.shift_local(*tco, delta))
    _close(via.numpy(), direct.numpy())


# (dim, leaf level, k, multipole, defer). 2D k = 2 has inner far shells
# (k < shell < c_min = 4) that reach the leaf pack outputs; 3D k = 3 is the
# θ = 0.25 default.
@pytest.mark.parametrize("dim,level,k,multipole,defer", [
    (2, 4, 2, "quad", "pack"), (2, 4, 2, "mono", "gather"),
    (3, 3, 3, "quad", "pack")])
def test_hier_far_coeffs_match_jax(dim, level, k, multipole, defer):
    rng = np.random.default_rng(level + k)
    n = 1500 if dim == 2 else 1200
    pos = rng.uniform(1.0, 1e7, (n, dim))
    mass = rng.uniform(1.0, 1e8, n)
    cap = jg.compute_capacity(jnp.asarray(pos), level)
    jtree = jg.build_grid_tree(jnp.asarray(pos), jnp.asarray(mass), level,
                               cap, quad=True)
    tree = _carried(jtree)
    want = jh.hier_far_coeffs(jtree, k, multipole=multipole, defer=defer)
    have = th.hier_far_coeffs(tree, k, multipole=multipole, defer=defer)
    for h, w in zip(have[0], want[0]):
        _close(h.numpy(), w)
    assert tuple(have[1].shape) == tuple(want[1].shape)
    _close(have[1].numpy(), want[1])
    assert (have[2] is None) == (want[2] is None)
    if want[2] is not None:
        _close(have[2].numpy(), want[2])
    if defer == "pack" and k == 2:
        assert have[1].shape[1] > 0  # the per-body shells are really there


def test_hier_chunked_sweep_matches_whole_level():
    """Parent chunks (a Python loop over the JAX package's lax.map chunks)
    change no value beyond f64 reassociation."""
    rng = np.random.default_rng(8)
    pos, mass = rng.uniform(1.0, 1e7, (1500, 2)), rng.uniform(1.0, 1e8, 1500)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    tree = tg.build_grid_tree(tp, tm, 4, tg.compute_capacity(tp, 4),
                              quad=True)
    whole = th.hier_far_coeffs(tree, 2)
    chunked = th.hier_far_coeffs(tree, 2, chunk_budget=100 * 4)
    for a, b in zip(list(whole[0]) + [whole[1], whole[2]],
                    list(chunked[0]) + [chunked[1], chunked[2]]):
        _close(b.numpy(), a.numpy())


def test_hier_wide_ring_no_double_count():
    """k ≥ 4 in 2D: shells ≤ k are the near ring's, and the sweep must not
    count them again (JAX's c_min clamp test, tests/test_local_expansion.py
    :427-441): < 1e-6 against the direct sum."""
    rng = np.random.default_rng(11)
    pos = torch.from_numpy(rng.uniform(1.0, 1e7, (1000, 2)))
    mass = torch.from_numpy(rng.uniform(1.0, 1e8, 1000))
    cfg = TGravity()
    got = tg.barnes_hut_grid(pos, mass, cfg, theta=0.125, leaf_level=3,
                             far_impl="hier")
    want = brute_force_direct(pos, mass, cfg)
    assert float(scale_normalized_error(got, want)) < 1e-6


def test_hier_matches_local_class_error():
    """far_impl='hier' stays within ~2× of the per-leaf 'local' mode (the
    JAX test at 4096 bodies, tests/test_local_expansion.py:356-373, here in
    2D at 2048)."""
    rng = np.random.default_rng(12)
    pos = torch.from_numpy(rng.uniform(1.0, 1e7, (2048, 2)))
    mass = torch.from_numpy(rng.uniform(1.0, 1e8, 2048))
    cfg = TGravity()
    want = brute_force_direct(pos, mass, cfg)
    errs = {f: float(scale_normalized_error(tg.barnes_hut_grid(
        pos, mass, cfg, theta=0.25, leaf_level=4, far_impl=f), want))
        for f in ("local", "hier")}
    assert errs["hier"] < max(2.0 * errs["local"], 1e-4), errs
