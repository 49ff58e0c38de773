"""Fast IGMN — the paper's contribution (precision-matrix form), in PyTorch.

Counterpart of ``repro.core.figmn``: the learning loop runs on the
precision matrix Λ = C⁻¹ and on log|C| maintained through rank-one updates,
so a learning step is O(K·D²) instead of O(K·D³).

One learning step (Algorithm 1):
  1. d²_M(x, j) = (x-μ_j)ᵀ Λ_j (x-μ_j)                       (eq. 22)
  2. if no active component satisfies d² < chi²_{D,1-β}: create (Alg. 3)
  3. else update every component (eqs. 3–10, 20–21, 25–26).

Inactive slots take a mathematical no-op path (posterior 0 ⇒ ω = 0 ⇒
identity update).  The branch of step 2 is a Python ``if`` on the gate:
on a CUDA state that is one host sync per point, counted in PERF.md.

In-place contract: where the reference donated the state to XLA, the port
may write the input state's Λ buffer in place (``backend="pallas"`` updates
through the in-place kernels, creation writes one slot).  A caller that
needs the input state afterwards passes ``state.clone()``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import (FIGMNConfig, FIGMNState, Tensor,
                                    gate_threshold, resolve_device)
from repro_torch.kernels import ops

_LOG_2PI = 1.8378770664093453


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def sigma_from_data(x: Tensor, delta: float) -> Tensor:
    """Per-dimension sigma_ini = delta * std(dataset) (eq. 13)."""
    std = torch.std(x, dim=0, correction=0)
    # Guard constant dimensions: a zero std would make Λ infinite.
    std = torch.where(std <= 1e-12, torch.ones_like(std), std)
    return delta * std


def _sigma(cfg: FIGMNConfig, device: torch.device) -> Tensor:
    sigma = cfg.sigma_ini
    if not torch.is_tensor(sigma):
        sigma = torch.tensor(np.asarray(sigma))   # copy: arrays may be read-only
    return torch.broadcast_to(sigma.to(device=device, dtype=cfg.dtype),
                              (cfg.dim,))


def init_state(cfg: FIGMNConfig, device=None) -> FIGMNState:
    """An empty pool on ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    k, d, dt = cfg.kmax, cfg.dim, cfg.dtype
    sigma = _sigma(cfg, device)
    # Λ_j = σ_ini⁻² I (diagonal ⇒ no inversion cost); |C| = Π σ_ini².
    lam0 = torch.zeros((k, d, d), dtype=dt, device=device) \
        + torch.diag(1.0 / (sigma * sigma))[None]
    logdet0 = torch.full((k,), float(torch.sum(2.0 * torch.log(sigma))),
                         dtype=dt, device=device)
    return FIGMNState(
        mu=torch.zeros((k, d), dtype=dt, device=device),
        lam=lam0,
        logdet=logdet0,
        sp=torch.zeros((k,), dtype=dt, device=device),
        v=torch.zeros((k,), dtype=dt, device=device),
        active=torch.zeros((k,), dtype=torch.bool, device=device),
        n_created=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Distance / densities
# ---------------------------------------------------------------------------

def mahalanobis_sq(state: FIGMNState, x: Tensor) -> Tensor:
    """(K,) squared Mahalanobis distance to every slot (eq. 22)."""
    diff = x[None, :] - state.mu
    return torch.einsum("kd,kde,ke->k", diff, state.lam, diff)


def _log_density(cfg: FIGMNConfig, state: FIGMNState, d2: Tensor) -> Tensor:
    """log p(x|j) (eq. 2) from precomputed d²."""
    return -0.5 * (cfg.dim * _LOG_2PI + state.logdet + d2)


def masked_posteriors(logp: Tensor, sp: Tensor, active: Tensor) -> Tensor:
    """THE masked log-posterior softmax (eq. 3 over a slot pool): prior
    p(j) ∝ sp_j, inactive slots exactly 0, the all-inactive case guarded.
    Slots live on the LAST axis; leading axes are batch."""
    logw = logp + torch.log(torch.clamp_min(sp, 1e-30))
    logw = torch.where(active, logw, torch.full_like(logw, -torch.inf))
    logw = torch.where(torch.any(active, dim=-1, keepdim=True), logw,
                       torch.zeros_like(logw))
    post = torch.softmax(logw, dim=-1)
    return torch.where(active, post, torch.zeros_like(post))


def posteriors(cfg: FIGMNConfig, state: FIGMNState, d2: Tensor) -> Tensor:
    """p(j|x) over the pool (eq. 3); inactive slots get exactly 0."""
    return masked_posteriors(_log_density(cfg, state, d2), state.sp,
                             state.active)


def _log_prior(sp: Tensor) -> Tensor:
    return torch.log(sp / torch.clamp_min(torch.sum(sp), 1e-30) + 1e-30)


def log_likelihood(cfg: FIGMNConfig, state: FIGMNState, x: Tensor) -> Tensor:
    """Mixture log-density log Σ_j p(x|j) p(j) of a single point."""
    logp = _log_density(cfg, state, mahalanobis_sq(state, x))
    logjoint = torch.where(state.active, logp + _log_prior(state.sp),
                           torch.full_like(logp, -torch.inf))
    return torch.logsumexp(logjoint, dim=0)


def log_joint_batch(cfg: FIGMNConfig, state: FIGMNState, xs: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """The ONE batched (B, K) mixture pass every reader shares: d² (B, K)
    and the log-joint (B, K), -inf on inactive slots.  It holds a (B, K, D)
    difference, so callers block B (``log_likelihood_batch``)."""
    diff = xs[:, None, :] - state.mu[None, :, :]          # (B, K, D)
    y = torch.einsum("kde,bke->bkd", state.lam, diff)
    d2 = torch.einsum("bkd,bkd->bk", diff, y)
    logp = -0.5 * (cfg.dim * _LOG_2PI + state.logdet[None, :] + d2)
    logjoint = torch.where(state.active[None, :],
                           logp + _log_prior(state.sp)[None, :],
                           torch.full_like(logp, -torch.inf))
    return d2, logjoint


def log_likelihood_batch(cfg: FIGMNConfig, state: FIGMNState, xs: Tensor,
                         block_b: int = 512) -> Tensor:
    """(B,) mixture log-densities from the shared batched pass, in blocks
    of ``block_b`` rows: a (B, K, D) difference at B = 1000, K = 64,
    D = 794 alone is 203 MB."""
    out = [torch.logsumexp(log_joint_batch(cfg, state, xs[i:i + block_b])[1],
                           dim=1)
           for i in range(0, xs.shape[0], block_b)]
    return torch.cat(out) if out else xs.new_zeros((0,))


def score_batch(cfg: FIGMNConfig, state: FIGMNState, xs: Tensor) -> Tensor:
    """(N,) mixture log-densities (vectorised over points, no state change)."""
    return log_likelihood_batch(cfg, state, xs)


# ---------------------------------------------------------------------------
# The two rank-one updates (the heart of the paper)
# ---------------------------------------------------------------------------

def precision_rank2_update(lam: Tensor, logdet: Tensor, e_star: Tensor,
                           dmu: Tensor, w: Tensor, dim: int
                           ) -> Tuple[Tensor, Tensor]:
    """Eqs. 20–21 (precision) and 25–26 (log-determinant) for all K slots.

    e_star = x − μ(t), dmu = μ(t) − μ(t-1), w = ω (0 for no-op slots).
    """
    one_m_w = 1.0 - w
    y = torch.einsum("kde,ke->kd", lam, e_star)          # Λ e*
    s = torch.einsum("kd,kd->k", e_star, y)              # e*ᵀ Λ e*
    denom1 = 1.0 + w * s / one_m_w
    coef1 = w / (one_m_w * one_m_w * denom1)
    lam_bar = lam / one_m_w[:, None, None] \
        - coef1[:, None, None] * torch.einsum("kd,ke->kde", y, y)
    yb = torch.einsum("kde,ke->kd", lam_bar, dmu)        # Λ̄ Δμ
    t = torch.einsum("kd,kd->k", dmu, yb)                # ΔμᵀΛ̄Δμ
    coef2 = 1.0 / (1.0 - t)
    lam_new = lam_bar + coef2[:, None, None] * torch.einsum("kd,ke->kde",
                                                            yb, yb)
    # log|·| of absolute values: the documented non-PSD regime of the
    # printed eq. 11 degrades like the covariance form instead of NaN-ing.
    logdet_new = logdet + dim * torch.log(one_m_w) \
        + torch.log(torch.abs(denom1)) + torch.log(torch.abs(1.0 - t))
    return lam_new, logdet_new


def precision_rank1_update_exact(lam: Tensor, logdet: Tensor, e: Tensor,
                                 w: Tensor, dim: int
                                 ) -> Tuple[Tensor, Tensor]:
    """Beyond-paper 'exact' mode: C(t) = (1-ω)C + ω(1-ω)eeᵀ, one
    Sherman–Morrison and one determinant-lemma step (e = x − μ(t-1))."""
    one_m_w = 1.0 - w
    y = torch.einsum("kde,ke->kd", lam, e)
    s = torch.einsum("kd,kd->k", e, y)
    coef = w / (1.0 + w * s)
    lam_new = (lam - coef[:, None, None] * torch.einsum("kd,ke->kde", y, y)) \
        / one_m_w[:, None, None]
    logdet_new = logdet + dim * torch.log(one_m_w) + torch.log1p(w * s)
    return lam_new, logdet_new


def fused_step_coeffs(d2: Tensor, w: Tensor, dim: int, update_mode: str
                      ) -> Tuple[Tensor, Tensor]:
    """Both e* = (1-ω)e and Δμ = ωe are multiples of e, so the whole update
    is a multiple of the ONE vector y = Λe the gate already computed:

        Λ(t) = Λ(t-1)/(1-ω) + β · y yᵀ          (paper mode)
        Λ(t) = (Λ(t-1) − β · y yᵀ) / (1-ω)      (exact mode)

    Returns (β, Δlog|C|)."""
    one_m_w = 1.0 - w
    if update_mode == "exact":
        beta = w / (1.0 + w * d2)
        dlogdet = dim * torch.log(one_m_w) + torch.log1p(w * d2)
        return beta, dlogdet
    denom1 = 1.0 + w * one_m_w * d2
    alpha = 1.0 / one_m_w - w * d2 / denom1             # Λ̄e = α·y
    t = w * w * alpha * d2                              # ΔμᵀΛ̄Δμ
    beta = -(w / denom1) + (w * alpha) ** 2 / (1.0 - t)
    dlogdet = dim * torch.log(one_m_w) + torch.log(torch.abs(denom1)) \
        + torch.log(torch.abs(1.0 - t))
    return beta, dlogdet


# ---------------------------------------------------------------------------
# Learning step
# ---------------------------------------------------------------------------

def _update(cfg: FIGMNConfig, state: FIGMNState, x: Tensor, d2: Tensor,
            y: Optional[Tensor] = None) -> FIGMNState:
    """Update all components with posterior weights (eqs. 3–10, 20–21,
    25–26).  y: the Λe of the distance pass (fused form) or None (the
    literal two-matvec formulation)."""
    post = posteriors(cfg, state, d2)                   # zeros on inactive
    v_new = state.v + state.active.to(cfg.dtype)        # eq. 4
    sp_new = state.sp + post                            # eq. 5
    e = x[None, :] - state.mu                           # eq. 6
    w = post / torch.clamp_min(sp_new, 1e-30)           # eq. 7  (ω)
    dmu = w[:, None] * e                                # eq. 8
    mu_new = state.mu + dmu                             # eq. 9
    e_star = x[None, :] - mu_new                        # eq. 10
    if y is not None and cfg.backend != "pallas":
        beta, dlogdet = fused_step_coeffs(d2, w, cfg.dim, cfg.update_mode)
        one_m_w = 1.0 - w
        yy = torch.einsum("kd,ke->kde", y, y)
        if cfg.update_mode == "exact":
            lam_new = (state.lam - beta[:, None, None] * yy) \
                / one_m_w[:, None, None]
        else:
            lam_new = state.lam / one_m_w[:, None, None] \
                + beta[:, None, None] * yy
        logdet_new = state.logdet + dlogdet
    elif cfg.backend == "pallas":
        if y is not None:
            lam_new, logdet_new = ops.fused_apply(
                state.lam, state.logdet, y, d2, w, cfg.dim, cfg.update_mode)
        elif cfg.update_mode == "exact":
            lam_new, logdet_new = ops.precision_rank1_update_exact(
                state.lam, state.logdet, e, w, cfg.dim)
        else:
            lam_new, logdet_new = ops.precision_rank2_update(
                state.lam, state.logdet, e_star, dmu, w, cfg.dim)
    elif cfg.update_mode == "exact":
        lam_new, logdet_new = precision_rank1_update_exact(
            state.lam, state.logdet, e, w, cfg.dim)
    else:
        lam_new, logdet_new = precision_rank2_update(
            state.lam, state.logdet, e_star, dmu, w, cfg.dim)
    return FIGMNState(mu=mu_new, lam=lam_new, logdet=logdet_new, sp=sp_new,
                      v=v_new, active=state.active,
                      n_created=state.n_created)


def _create(cfg: FIGMNConfig, state: FIGMNState, x: Tensor) -> FIGMNState:
    """Algorithm 3: activate a free slot at μ = x, Λ = σ_ini⁻² I.

    The slot stays on the device (no host sync): the first free slot, or —
    pool exhausted — the weakest component (first index on ties, as
    jnp.argmax/argmin).  Λ is written in place on that one slot."""
    dt = cfg.dtype
    free = ~state.active
    slot_free = torch.argmax(free.to(torch.int32))
    slot_weak = torch.argmin(torch.where(
        state.active, state.sp, torch.full_like(state.sp, torch.inf)))
    slot = torch.where(torch.any(free), slot_free, slot_weak)
    onehot = (torch.arange(cfg.kmax, device=x.device) == slot).to(dt)
    sigma = _sigma(cfg, x.device)
    lam0 = torch.diag(1.0 / (sigma * sigma))
    logdet0 = torch.sum(2.0 * torch.log(sigma))
    sel = onehot[:, None]
    lam = state.lam.index_copy_(0, slot.reshape(1), lam0[None])
    return FIGMNState(
        mu=state.mu * (1 - sel) + x[None, :] * sel,
        lam=lam,
        logdet=state.logdet * (1 - onehot) + logdet0 * onehot,
        sp=state.sp * (1 - onehot) + onehot,            # sp = 1
        v=state.v * (1 - onehot) + onehot,              # v = 1
        active=state.active | (onehot > 0),
        n_created=state.n_created + 1,
    )


def prune(cfg: FIGMNConfig, state: FIGMNState) -> FIGMNState:
    """§2.3: deactivate components with v > vmin and sp < spmin."""
    remove = state.active & (state.v > cfg.vmin) & (state.sp < cfg.spmin)
    return FIGMNState(mu=state.mu, lam=state.lam, logdet=state.logdet,
                      sp=state.sp, v=state.v, active=state.active & ~remove,
                      n_created=state.n_created)


def _learn_one(cfg: FIGMNConfig, state: FIGMNState, x: Tensor,
               thresh: float, do_prune: bool) -> FIGMNState:
    if cfg.fused:
        diff = x[None, :] - state.mu                    # (K, D)
        if cfg.backend == "pallas":
            y = ops.matvec(state.lam, diff)
        else:
            y = torch.einsum("kde,ke->kd", state.lam, diff)
        d2 = torch.einsum("kd,kd->k", diff, y)
    else:
        y = None
        d2 = mahalanobis_sq(state, x)
    # The one host sync of a step: the gate picks the branch.
    if bool(torch.any(state.active & (d2 < thresh))):
        state = _update(cfg, state, x, d2, y)
    else:
        state = _create(cfg, state, x)
    if do_prune and cfg.spmin > 0:
        state = prune(cfg, state)
    return state


def learn_one(cfg: FIGMNConfig, state: FIGMNState, x: Tensor,
              do_prune: bool = True) -> FIGMNState:
    """Process one data point (Algorithm 1 body).  May write the input
    state's Λ in place (see the module docstring)."""
    return _learn_one(cfg, state, x.to(cfg.dtype), gate_threshold(cfg),
                      do_prune)


def fit(cfg: FIGMNConfig, state: FIGMNState, xs: Tensor,
        do_prune: bool = True) -> FIGMNState:
    """Single-pass fit over a stream ``xs`` of shape (N, D).  The state is
    consumed: its Λ buffer may be updated in place."""
    xs = xs.to(device=state.device, dtype=cfg.dtype)
    thresh = gate_threshold(cfg)
    for i in range(xs.shape[0]):
        state = _learn_one(cfg, state, xs[i], thresh, do_prune)
    return state
