"""Mixture merging (counterpart of ``repro.core.merge``).

Merging two Gaussian mixtures is exact: the union of their (sp-weighted)
components is the mixture of the combined stream up to assignment noise.
When a pool exceeds its budget, the two most similar components are
moment-matched:

    sp = sp_a + sp_b,   μ = (sp_a μ_a + sp_b μ_b)/sp
    C  = Σ_i (sp_i/sp) (C_i + (μ_i-μ)(μ_i-μ)ᵀ)

which keeps the first two moments of the pair.  That needs C = Λ⁻¹ of the
merged slots, O(D³) per merge, but merges are rare and off the per-point
path.  The reference has no Pallas kernel here: these are ``torch.linalg``
calls on the state's device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.types import FIGMNConfig, FIGMNState


def top_k_by_sp(state: FIGMNState, kmax: int) -> FIGMNState:
    """Keep the kmax highest-sp active slots, inactive ones last; ties keep
    the lower index first (as ``jax.lax.top_k``)."""
    score = torch.where(state.active, state.sp,
                        torch.full_like(state.sp, -torch.inf))
    idx = torch.sort(score, descending=True, stable=True).indices[:kmax]
    return FIGMNState(
        mu=state.mu[idx], lam=state.lam[idx], logdet=state.logdet[idx],
        sp=state.sp[idx], v=state.v[idx], active=state.active[idx],
        n_created=state.n_created)


def union(cfg: FIGMNConfig, states: Sequence[FIGMNState]) -> FIGMNState:
    """Exact merge: the union of all pools' components, truncated to
    cfg.kmax by dropping the weakest slots (the §2.3 prune candidates).
    With cfg.kmax ≥ the total slot count it is lossless: sp is additive
    across pools, so the priors (eq. 12) renormalise by themselves."""
    big = FIGMNState(
        mu=torch.cat([s.mu for s in states]),
        lam=torch.cat([s.lam for s in states]),
        logdet=torch.cat([s.logdet for s in states]),
        sp=torch.cat([s.sp for s in states]),
        v=torch.cat([s.v for s in states]),
        active=torch.cat([s.active for s in states]),
        n_created=sum(s.n_created for s in states))
    return top_k_by_sp(big, cfg.kmax)


def moment_match_pair(cfg: FIGMNConfig, state: FIGMNState, ia: int,
                      ib: int) -> FIGMNState:
    """Moment-match slots ia, ib into ia and deactivate ib.  O(D³); returns
    a new state (the input is left as it was)."""
    sp_a, sp_b = state.sp[ia], state.sp[ib]
    sp = sp_a + sp_b
    wa, wb = sp_a / sp, sp_b / sp
    mu = wa * state.mu[ia] + wb * state.mu[ib]
    da = state.mu[ia] - mu
    db = state.mu[ib] - mu
    cov_a = torch.linalg.inv(state.lam[ia])
    cov_b = torch.linalg.inv(state.lam[ib])
    cov = wa * (cov_a + torch.outer(da, da)) \
        + wb * (cov_b + torch.outer(db, db))
    lam_new = torch.linalg.inv(cov)
    logdet_new = torch.linalg.slogdet(cov)[1]
    mu_s, lam_s = state.mu.clone(), state.lam.clone()
    logdet_s, sp_s, v_s = (state.logdet.clone(), state.sp.clone(),
                           state.v.clone())
    active = state.active.clone()
    mu_s[ia] = mu
    lam_s[ia] = lam_new
    logdet_s[ia] = logdet_new
    sp_s[ia] = sp
    sp_s[ib] = 0.0
    v_s[ia] = torch.maximum(state.v[ia], state.v[ib])
    active[ib] = False
    return FIGMNState(mu=mu_s, lam=lam_s, logdet=logdet_s, sp=sp_s, v=v_s,
                      active=active, n_created=state.n_created)


def closest_pair(state: FIGMNState) -> Tuple[int, int]:
    """The most similar active pair by symmetric squared Mahalanobis
    distance d(a,b) = (μa−μb)ᵀ(Λa+Λb)(μa−μb), O(K²D²) operations through
    one (K, K, D) intermediate: never the (K, K, D, D) of Λa+Λb.  Only the
    Λa term is evaluated; the difference is antisymmetric, so the Λb term
    at (a, b) is the Λa term at (b, a) and the whole matrix is q + qᵀ.
    The first pair in row-major order wins ties (a < b).  One host sync."""
    diff = state.mu[:, None, :] - state.mu[None, :, :]             # (K,K,D)
    ya = torch.einsum("ade,abe->abd", state.lam, diff)             # Λa diff
    q = torch.einsum("abd,abd->ab", diff, ya)
    d = q + q.T
    k = state.active.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=d.device)
    mask = state.active[:, None] & state.active[None, :] & ~eye
    d = torch.where(mask, d, torch.full_like(d, torch.inf))
    flat = int(torch.argmin(d))
    return flat // k, flat % k


def merge_to_budget(cfg: FIGMNConfig, state: FIGMNState, budget: int
                    ) -> Tuple[FIGMNState, int]:
    """Moment-match closest pairs until at most ``budget`` slots are live.
    Mass-exact (every step is a ``moment_match_pair``, never a
    truncation).  Returns (state, number of merges)."""
    merged = 0
    while int(state.n_active) > budget:
        ia, ib = closest_pair(state)
        state = moment_match_pair(cfg, state, ia, ib)
        merged += 1
    return state, merged
