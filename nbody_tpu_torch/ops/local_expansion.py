"""Order-2/3 local (Taylor) expansions of far-field cell accelerations.

Port of ``nbody_tpu.ops.local_expansion``, term by term. Instead of
evaluating every accepted source cell at every target body, the cells'
acceleration field is accumulated into a Taylor expansion at one centre per
target group and evaluated once per body:

    a(c + ρ) ≈ a0 + J·ρ + ½ ρᵀH ρ (+ ⅙ K ρρρ),

with a0 = a(c), J = ∂a/∂x, H = ∂²a/∂x², K = ∂³a/∂x³ at c. The closed forms
are written in the normalized variables of ``grid_tree._quad_cell_accel``
(n = R/r is O(1), Ŝ = S/r² is mass-scale), because raw r⁻⁵/r⁻⁷ powers leave
fp32 range at the reference's 1e7 coordinates. The JAX tests pin every term
against ``jax.jacfwd``; ``tests/test_torch_local_expansion.py`` holds these
against the JAX functions.

Packing: J and H are symmetric, stored as upper-triangle components — J
uses ``grid_tree._quad_pairs`` (3 / 6 in 2D / 3D), H its fully-symmetric
triples (4 / 10), K its quadruples (5 / 15).
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch

from .brute_force import _DIST2_GUARD
from .grid_tree import _quad_pairs

# Default eligibility threshold on the worst-case Taylor ratio |ρ|/d, shared
# by every caller that gates levels into the local expansion.
LOCAL_RATIO_DEFAULT = 0.18


def ring_level_is_local(dim: int, k: int, L: int, l: int,
                        ratio: float = LOCAL_RATIO_DEFAULT,
                        include_leaf: bool = False) -> bool:
    """Is ring level ``l`` of an L-level grid local-eligible?

    Worst-case ratio of a leaf-centred expansion against level-l V-list
    cells: (√D/2)·h over k·h·2^(L−l). The leaf level (l = L) is eligible
    only with ``include_leaf`` (``far_impl="local_leaf"``).
    """
    if l >= L:
        return include_leaf and l == L
    return (dim ** 0.5) / (2.0 * k * (1 << (L - l))) <= ratio


def _h_triples(dim: int):
    """Packed index triples of the fully-symmetric third-derivative tensor."""
    return list(itertools.combinations_with_replacement(range(dim), 3))


def _k_quads(dim: int):
    """Packed index quadruples of the fully-symmetric ∂³a tensor (order 3)."""
    return list(itertools.combinations_with_replacement(range(dim), 4))


def local_coeffs(center: torch.Tensor, com: torch.Tensor, mass: torch.Tensor,
                 S: Optional[torch.Tensor] = None,
                 softening: float = 0.0,
                 order3: bool = False) -> Tuple[torch.Tensor, ...]:
    """Accumulate (a0, J, H[, K]) at ``center`` from source cells.

    center [..., D]; com [..., K, D]; mass [..., K] (masked-out cells carry
    mass 0); S [..., K, nq] COM-centred second moments or None. Returns
    a0 [..., D], J [..., nj], H [..., nh] (and K [..., nk] with ``order3``),
    each summed over the K axis. With R = com − center, u = (r²+ε²)^{-1/2},
    n = R·u, Ŝ = S·u², t = Ŝn, q = nᵀŜn:

      a0  = M n u²  +  u²[(7.5q − 1.5 trŜ)n − 3t]
      J_ab = M u³(3 n_a n_b − δ_ab)
           + u³[3Ŝ_ab − 15(t_a n_b + t_b n_a) + 1.5 trŜ δ_ab
                − 7.5 trŜ n_a n_b + 52.5 q n_a n_b − 7.5 q δ_ab]
      H_abc = 3 M u⁴ (5 n_a n_b n_c − δ_ab n_c − δ_ac n_b − δ_bc n_a)
      K_abcd = 3 M u⁵ (35 n_a n_b n_c n_d − 5 Σ_6 δ n n + Σ_3 δ δ)

    (H and K keep the monopole term only, as in the JAX package.)
    """
    dim = center.shape[-1]
    qpairs = _quad_pairs(dim)
    triples = _h_triples(dim)

    R = [com[..., d] - center[..., None, d] for d in range(dim)]  # [..., K]
    r2 = R[0] * R[0]
    for Rd in R[1:]:
        r2 = r2 + Rd * Rd
    soft = torch.tensor(softening, dtype=r2.dtype)
    u = torch.rsqrt(r2 + soft * soft)
    u = torch.where(r2 < _DIST2_GUARD, torch.zeros_like(u), u)
    u2 = u * u
    u3 = u2 * u
    n = [Rd * u for Rd in R]

    M = mass
    Mu2 = M * u2
    Mu3 = M * u3

    a0 = [Mu2 * n[d] for d in range(dim)]
    Jp = [Mu3 * (3.0 * n[a] * n[b] - (1.0 if a == b else 0.0))
          for a, b in qpairs]
    Mu4_3 = 3.0 * Mu3 * u
    Hp = []
    for a, b, c in triples:
        t5 = 5.0 * n[a] * n[b] * n[c]
        if a == b:
            t5 = t5 - n[c]
        if a == c:
            t5 = t5 - n[b]
        if b == c:
            t5 = t5 - n[a]
        Hp.append(Mu4_3 * t5)

    Kp = None
    if order3:
        Mu5_3 = Mu4_3 * u
        Kp = []
        for a, b, c, d in _k_quads(dim):
            t = 35.0 * n[a] * n[b] * n[c] * n[d]
            for (x, y), (z, w) in (((a, b), (c, d)), ((a, c), (b, d)),
                                   ((a, d), (b, c))):
                if x == y:
                    t = t - 5.0 * n[z] * n[w]
                if z == w:
                    t = t - 5.0 * n[x] * n[y]
                if x == y and z == w:
                    t = t + 1.0
            Kp.append(Mu5_3 * t)

    if S is not None:
        s_hat = {p: S[..., i] * u2 for i, p in enumerate(qpairs)}

        def sh(a, b):
            return s_hat[(a, b)] if (a, b) in s_hat else s_hat[(b, a)]

        t = [sum(sh(d, e) * n[e] for e in range(dim)) for d in range(dim)]
        q = sum(n[d] * t[d] for d in range(dim))
        trS = sum(sh(d, d) for d in range(dim))
        rad = (7.5 * q - 1.5 * trS) * u2
        for d in range(dim):
            a0[d] = a0[d] + rad * n[d] - (3.0 * u2) * t[d]
        for i, (a, b) in enumerate(qpairs):
            term = (3.0 * sh(a, b)
                    - 15.0 * (t[a] * n[b] + t[b] * n[a])
                    + (52.5 * q - 7.5 * trS) * n[a] * n[b])
            if a == b:
                term = term + 1.5 * trS - 7.5 * q
            Jp[i] = Jp[i] + u3 * term

    def packed(terms):
        return torch.stack([x.sum(dim=-1) for x in terms], dim=-1)

    if order3:
        return packed(a0), packed(Jp), packed(Hp), packed(Kp)
    return packed(a0), packed(Jp), packed(Hp)


def eval_local(rho: torch.Tensor, a0: torch.Tensor, Jp: torch.Tensor,
               Hp: torch.Tensor, Kp: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Evaluate the packed local expansion at body offsets.

    rho [..., T, D] (body − center); a0 [..., D]; Jp [..., nj]; Hp [..., nh];
    optional Kp [..., nk] → acceleration increments [..., T, D].
    """
    dim = rho.shape[-1]
    jidx = {p: i for i, p in enumerate(_quad_pairs(dim))}
    hidx = {t: i for i, t in enumerate(_h_triples(dim))}

    def J(a, b):
        i = jidx[(a, b)] if (a, b) in jidx else jidx[(b, a)]
        return Jp[..., None, i]

    def H(a, b, c):
        return Hp[..., None, hidx[tuple(sorted((a, b, c)))]]

    rho_d = [rho[..., d] for d in range(dim)]
    out = []
    for a in range(dim):
        acc = a0[..., None, a]
        for b in range(dim):
            acc = acc + J(a, b) * rho_d[b]
        # ½ Σ_bc H_abc ρ_b ρ_c over unique (b, c) with multiplicity.
        for b in range(dim):
            acc = acc + 0.5 * H(a, b, b) * rho_d[b] * rho_d[b]
            for c in range(b + 1, dim):
                acc = acc + H(a, b, c) * rho_d[b] * rho_d[c]
        out.append(acc)
    acc = torch.stack(out, dim=-1)
    if Kp is not None:
        # (1/6) Σ_bcd K_abcd ρ_b ρ_c ρ_d over sorted (b ≤ c ≤ d) with
        # permutation multiplicity.
        kidx = {q: i for i, q in enumerate(_k_quads(dim))}
        out3 = []
        for a in range(dim):
            acc3 = 0.0
            for b, c, d in itertools.combinations_with_replacement(
                    range(dim), 3):
                if b == c == d:
                    mult = 1
                elif b == c or c == d:
                    mult = 3
                else:
                    mult = 6
                i = kidx[tuple(sorted((a, b, c, d)))]
                acc3 = acc3 + (mult / 6.0) * Kp[..., None, i] \
                    * rho_d[b] * rho_d[c] * rho_d[d]
            out3.append(acc3)
        acc = acc + torch.stack(out3, dim=-1)
    return acc


def shift_local(a0: torch.Tensor, Jp: torch.Tensor, Hp: torch.Tensor,
                Kp: torch.Tensor, delta) -> Tuple[torch.Tensor, ...]:
    """Re-centre an order-3 local expansion from c to c + delta (L2L), exact.

      a0'    = a0 + J δ + ½ δᵀHδ + (1/6) K δδδ
      J'_ab  = J_ab + Σ_c H_abc δ_c + ½ Σ_cd K_abcd δ_c δ_d
      H'_abc = H_abc + Σ_d K_abcd δ_d
      K'     = K
    """
    dim = a0.shape[-1]
    delta = torch.as_tensor(delta, dtype=a0.dtype,
                            device=a0.device).expand(a0.shape)
    a0p = eval_local(delta[..., None, :], a0, Jp, Hp, Kp)[..., 0, :]

    hidx = {t: i for i, t in enumerate(_h_triples(dim))}
    kidx = {q: i for i, q in enumerate(_k_quads(dim))}
    d_d = [delta[..., d] for d in range(dim)]

    def H(a, b, c):
        return Hp[..., hidx[tuple(sorted((a, b, c)))]]

    def KK(a, b, c, d):
        return Kp[..., kidx[tuple(sorted((a, b, c, d)))]]

    Jp_new = []
    for i, (a, b) in enumerate(_quad_pairs(dim)):
        t = Jp[..., i]
        for c in range(dim):
            t = t + H(a, b, c) * d_d[c]
        for c in range(dim):
            t = t + 0.5 * KK(a, b, c, c) * d_d[c] * d_d[c]
            for e in range(c + 1, dim):
                t = t + KK(a, b, c, e) * d_d[c] * d_d[e]
        Jp_new.append(t)
    Hp_new = []
    for i, (a, b, c) in enumerate(_h_triples(dim)):
        t = Hp[..., i]
        for d in range(dim):
            t = t + KK(a, b, c, d) * d_d[d]
        Hp_new.append(t)
    return (a0p, torch.stack(Jp_new, dim=-1), torch.stack(Hp_new, dim=-1),
            Kp)


def num_coeffs(dim: int) -> Tuple[int, int, int]:
    """(len a0, len J packed, len H packed) for carry allocation."""
    return dim, len(_quad_pairs(dim)), len(_h_triples(dim))


def num_coeffs3(dim: int) -> int:
    """len K packed (order-3 term) for carry allocation."""
    return len(_k_quads(dim))
