"""Top-C component shortlists: sublinear-in-K hot paths (write AND read).

Counterpart of ``repro.core.shortlist``.  Posteriors decay like
exp(-d²/2), so past a few Mahalanobis radii a component's update is the
identity (ω = 0).  This engine touches C of the K (D, D) precision blocks
per point instead of all of them:

  bound pass   O(K·D)   ``shortlist_scores``: rank every slot by the diag(Λ)
                        quadratic plus the logdet + log-prior bias of the
                        true posterior.  The (K, D) diag(Λ) cache rides the
                        loop and is maintained analytically on C rows.
  top-C        O(K)     ``topc``: a stable descending sort (ties to the lower
                        index, as ``lax.top_k``) and an ascending sort of
                        the C winners, so at C = K the gather is the identity
                        permutation.
  exact pass   O(C·D²)  the exact matvec, posterior softmax and fused
                        rank-one update on the C gathered rows, written back
                        in place — with ``backend="pallas"`` through the
                        ``gathered_matvec`` and ``scatter_apply`` kernels.

Exactness contract (tests/test_torch_shortlist.py): with C ≥ active K the
shortlist holds every live slot and ``fit_sparse`` is BIT-IDENTICAL to the
dense fused ``figmn.fit`` (plain backend).  The learning step is
branch-free: the gate is a 0-dim device bool feeding ``torch.where``, so a
step pays no host sync (the dense ``learn_one`` pays one per point).

In-place contract, as in ``core.figmn``: the step writes the input state's
Λ buffer (the C shortlisted rows and the creation row) and, with
``backend="pallas"``, its logdet; it consumes its input state.  A caller
that needs the input state afterwards passes ``state.clone()``.

The read path shares the shortlist: ``score_batch_sparse`` runs one (B, K)
bound pass and a (B, C) exact pass.  ``backend`` picks kernels for the
write path only: on the card the reads' (B, C) products always run
through the ``gathered_matvec`` kernel over the flattened (point, slot)
pairs (float32 only), so the (B, C, D, D) gathered rows are never built;
on the CPU they take its plain version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import figmn
from repro_torch.core.types import FIGMNConfig, FIGMNState, Tensor, \
    gate_threshold
from repro_torch.kernels import _build, ops, ref

_LOG_2PI = figmn._LOG_2PI


def effective_c(cfg: FIGMNConfig) -> int:
    """The static shortlist width: cfg.shortlist_c clamped to the pool.

    Also validates the config: the sparse step IS the fused formulation,
    so cfg.fused=False has no sparse counterpart and is rejected.
    """
    if not cfg.fused:
        raise ValueError(
            "the shortlist path requires cfg.fused=True (its exact pass is "
            "the fused single-matvec form; the unfused eq-by-eq "
            "formulation exists only for the dense faithfulness tests)")
    c = int(cfg.shortlist_c)
    if c <= 0:
        raise ValueError(
            "shortlist paths need cfg.shortlist_c > 0 "
            f"(got {cfg.shortlist_c}); 0 means 'use the dense path'")
    return min(c, int(cfg.kmax))


def lam_diag(state: FIGMNState) -> Tensor:
    """(K, D) diag(Λ), a copy (Λ is updated in place): the bound-pass
    cache, O(K·D) to (re)build."""
    return torch.diagonal(state.lam, dim1=1, dim2=2).clone()


def _proxy_bias(state: FIGMNState) -> Tensor:
    """(K,) per-slot bias of the "diag" proxy: -½log|C| + log sp — the ONE
    definition the write-path and read-path rankers share."""
    return -0.5 * state.logdet + torch.log(torch.clamp_min(state.sp, 1e-30))


def shortlist_scores(cfg: FIGMNConfig, state: FIGMNState, diag: Tensor,
                     x: Tensor) -> Tensor:
    """(K,) proxy for the unnormalised log joint, O(K·D), -inf on inactive.

    "diag" mode scores -½(log|C| + Σ_d Λ_dd δ_d²) + log sp; "euclid" ranks
    by plain squared distance.
    """
    diff = x[None, :] - state.mu                          # (K, D)
    if cfg.shortlist_mode == "euclid":
        scores = -0.5 * torch.sum(diff * diff, dim=1)
    elif cfg.shortlist_mode == "diag":
        d2_diag = torch.sum(diag * diff * diff, dim=1)
        scores = _proxy_bias(state) - 0.5 * d2_diag
    else:
        raise ValueError(f"unknown shortlist_mode {cfg.shortlist_mode!r}")
    return torch.where(state.active, scores,
                       torch.full_like(scores, -torch.inf))


def topc(scores: Tensor, c: int) -> Tensor:
    """Top-c indices over the last axis, sorted ascending (int64).

    ``torch.topk`` leaves the order of ties unspecified and inactive slots
    all score -inf, so this takes a STABLE descending sort — ties go to the
    lower index, as ``jax.lax.top_k`` breaks them — and sorts the c winners
    ascending: at c = K the gather that follows is the identity
    permutation, and at active K ≤ c it holds every live slot.  The write
    path (one point, (K,)) and the read path ((B, K)) both call it.
    """
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[..., :c], dim=-1).values


# ---------------------------------------------------------------------------
# Write path: sparse learning step
# ---------------------------------------------------------------------------

class StepConsts(NamedTuple):
    """What every sparse step reuses, built once per ``fit_sparse``: the
    gate threshold and the fresh component of Algorithm 3."""
    thresh: float        # chi² gate, a float holding the float32 value
    inv_var: Tensor      # (D,) σ_ini⁻²: diag(Λ) of a fresh component
    lam0_row: Tensor     # (1, D, D) σ_ini⁻² I
    logdet0: Tensor      # () Σ 2 log σ_ini


def step_consts(cfg: FIGMNConfig, device: torch.device) -> StepConsts:
    sigma = figmn._sigma(cfg, device)
    inv_var = 1.0 / (sigma * sigma)
    return StepConsts(thresh=gate_threshold(cfg), inv_var=inv_var,
                      lam0_row=torch.diag(inv_var)[None],
                      logdet0=torch.sum(2.0 * torch.log(sigma)))


def learn_one_sparse(cfg: FIGMNConfig, state: FIGMNState, diag: Tensor,
                     x: Tensor, do_prune: bool = True,
                     consts: Optional[StepConsts] = None
                     ) -> Tuple[FIGMNState, Tensor]:
    """One sparse learning step: O(K·D) bound pass + O(C·D²) exact work.

    diag is the (K, D) diag(Λ) cache (``lam_diag``); the caller threads it
    through the loop.  ``consts`` (``step_consts``) is built here when not
    given.

    BRANCH-FREE, with no host sync: both outcomes are predicated row
    writes.  The C shortlisted rows take ``where(accept, updated,
    original)`` (with ``backend="pallas"`` ω is gated to 0 on a failure,
    so the kernel's row pass multiplies by 1.0 and subtracts ±0); creation
    (Algorithm 3) is one more predicated row write at the slot
    ``figmn._create`` would pick.  Every formula is the one the dense fused
    path runs, so C ≥ active K stays bit-identical to the dense scan.
    The input state is consumed: its Λ (and, with ``backend="pallas"``,
    its logdet) is written in place.
    """
    c = effective_c(cfg)
    dt = cfg.dtype
    if consts is None:
        consts = step_consts(cfg, x.device)
    x = x.to(dt)
    idx = topc(shortlist_scores(cfg, state, diag, x), c)    # (C,) int64
    mu_sel = state.mu[idx]
    diff = x[None, :] - mu_sel                               # (C, D)
    if cfg.backend == "pallas":
        y = ops.gathered_matvec(state.lam, diff, idx)
    else:
        y = torch.einsum("kde,ke->kd", state.lam[idx], diff)
    d2 = torch.einsum("kd,kd->k", diff, y)                   # eq. 22 on C
    active_sel = state.active[idx]
    acc = torch.any(active_sel & (d2 < consts.thresh))       # 0-dim, device

    # -- update values on the C rows (figmn._update on the gather) --------
    logdet_sel = state.logdet[idx]
    sp_sel = state.sp[idx]
    logp = -0.5 * (cfg.dim * _LOG_2PI + logdet_sel + d2)
    post = figmn.masked_posteriors(logp, sp_sel, active_sel)
    sp_new_sel = sp_sel + post                               # eq. 5
    w = post / torch.clamp_min(sp_new_sel, 1e-30)            # eq. 7
    mu_new_sel = mu_sel + w[:, None] * diff                  # eqs. 8–9
    beta, dlogdet = figmn.fused_step_coeffs(d2, w, cfg.dim, cfg.update_mode)
    one_m_w = 1.0 - w
    # diag(Λ) maintained analytically from the same coefficients
    diag_sel = diag[idx]
    yy_diag = y * y
    if cfg.update_mode == "exact":
        diag_new_sel = (diag_sel - beta[:, None] * yy_diag) \
            / one_m_w[:, None]
    else:
        diag_new_sel = diag_sel / one_m_w[:, None] + beta[:, None] * yy_diag

    # -- predicated write of the C rows -----------------------------------
    if cfg.backend == "pallas":
        w_gated = torch.where(acc, w, 0.0)
        lam1, logdet1 = ops.scatter_fused_apply(
            state.lam, state.logdet, idx, y, d2, w_gated, cfg.dim,
            cfg.update_mode)
    else:
        lam_sel = state.lam[idx]                             # (C, D, D)
        yy = torch.einsum("kd,ke->kde", y, y)
        if cfg.update_mode == "exact":
            lam_new_sel = (lam_sel - beta[:, None, None] * yy) \
                / one_m_w[:, None, None]
        else:
            lam_new_sel = lam_sel / one_m_w[:, None, None] \
                + beta[:, None, None] * yy
        lam1 = state.lam.index_copy_(0, idx,
                                     torch.where(acc, lam_new_sel, lam_sel))
        logdet1 = state.logdet.index_copy(
            0, idx, torch.where(acc, logdet_sel + dlogdet, logdet_sel))
    mu1 = state.mu.index_copy(0, idx, torch.where(acc, mu_new_sel, mu_sel))
    sp1 = state.sp.index_copy(0, idx, torch.where(acc, sp_new_sel, sp_sel))
    diag1 = diag.index_copy(0, idx, torch.where(acc, diag_new_sel, diag_sel))
    v1 = state.v + torch.where(acc, state.active.to(dt), 0.0)   # eq. 4

    # -- predicated creation write (Algorithm 3, one row) ------------------
    free = ~state.active
    slot_weak = torch.argmin(torch.where(
        state.active, state.sp, torch.full_like(state.sp, torch.inf)))
    slot = torch.where(torch.any(free), torch.argmax(free.to(torch.int32)),
                       slot_weak).reshape(1)                 # (1,) on device

    def put(t: Tensor, fresh, inplace: bool = False) -> Tensor:
        row = torch.where(acc, t.index_select(0, slot), fresh)
        return t.index_copy_(0, slot, row) if inplace \
            else t.index_copy(0, slot, row)

    state = FIGMNState(
        mu=put(mu1, x[None, :]),
        lam=put(lam1, consts.lam0_row, inplace=True),
        logdet=put(logdet1, consts.logdet0),
        sp=put(sp1, 1.0),
        v=put(v1, 1.0),
        active=put(state.active, True),
        n_created=state.n_created + torch.where(acc, 0, 1).to(torch.int32))
    diag2 = put(diag1, consts.inv_var[None, :])
    if do_prune and cfg.spmin > 0:
        state = figmn.prune(cfg, state)
    return state, diag2


def fit_sparse(cfg: FIGMNConfig, state: FIGMNState, xs: Tensor,
               do_prune: bool = True) -> FIGMNState:
    """Single-pass sparse fit over (N, D): the "sparse" ingest body.

    The diag(Λ) cache and the step constants are built once; the loop
    makes no host sync.  The state is consumed (Λ updated in place)."""
    xs = xs.to(device=state.device, dtype=cfg.dtype)
    consts = step_consts(cfg, state.device)
    diag = lam_diag(state)
    for i in range(xs.shape[0]):
        state, diag = learn_one_sparse(cfg, state, diag, xs[i], do_prune,
                                       consts)
    return state


# ---------------------------------------------------------------------------
# Read path: shortlisted batched scoring
# ---------------------------------------------------------------------------

def gathered_products(mats: Tensor, diff: Tensor, idx: Tensor) -> Tensor:
    """(B, C, D): mats[idx_bc]·diff_bc for every (point, slot) pair.

    The choice is by device, never by ``cfg.backend`` or dtype.  On the
    card the flattened pairs always go through the ``gathered_matvec``
    kernel, so the (B, C, D, D) gathered rows (10.3 GB per 512-row block
    at K = 64, D = 794, C = 8) are never built; its wrapper takes float32
    only and raises on any other dtype, as the write kernels do.  On the
    CPU the plain version runs, at any dtype, as in the reference."""
    b, c, d = diff.shape
    flat, fidx = diff.reshape(b * c, d).contiguous(), idx.reshape(-1)
    if _build.on_cuda(mats.device):
        y = ops.gathered_matvec(mats, flat, fidx)
    else:
        y = ref.gathered_matvec_ref(mats, flat, fidx)
    return y.reshape(b, c, d)


def score_batch_sparse(cfg: FIGMNConfig, state: FIGMNState, xs: Tensor,
                       c: Optional[int] = None, block_b: int = 512) -> Tensor:
    """(B,) mixture log-densities, O(B·K·D + B·C·D²) instead of O(B·K·D²).

    One (B, K) bound pass (three matmuls) ranks the slots per point; the
    exact Mahalanobis/log-density pass runs on the (B, C) shortlist and
    log-sum-exps over it.  Rows are blocked by ``block_b``.
    """
    c = min(int(cfg.shortlist_c if c is None else c),
            int(state.active.shape[0]))
    if c <= 0:
        raise ValueError("score_batch_sparse needs a positive shortlist "
                         "width (cfg.shortlist_c or the c argument)")
    xs = xs.to(cfg.dtype)
    caches = _bound_caches(state)
    out = [torch.logsumexp(
        _topc_exact_batch(cfg, state, caches, xs[i:i + block_b], c)[2],
        dim=1) for i in range(0, xs.shape[0], block_b)]
    return torch.cat(out) if out else xs.new_zeros((0,))


def _bound_caches(state: FIGMNState
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(diag(Λ), log-prior, diag·μ, Σ diag·μ², proxy bias): the O(K·D)
    precompute the batched bound pass shares across blocks."""
    diag = lam_diag(state)
    logprior = torch.log(state.sp / torch.clamp_min(torch.sum(state.sp),
                                                    1e-30) + 1e-30)
    dmu = diag * state.mu                                 # (K, D)
    m2 = torch.sum(dmu * state.mu, dim=1)                 # (K,)
    return diag, logprior, dmu, m2, _proxy_bias(state)


def _topc_exact_batch(cfg: FIGMNConfig, state: FIGMNState, caches,
                      xb: Tensor, c: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The ONE batched shortlisted pass every reader shares: (B, K) bound
    pass → top-C → exact (B, C) Mahalanobis/log-joint.  Returns (idx (B, C),
    d² (B, C), log-joint (B, C) with -inf on inactive)."""
    diag, logprior, dmu, m2, bias = caches
    if cfg.shortlist_mode == "euclid":
        proxy = -0.5 * (torch.sum(xb * xb, dim=1)[:, None]
                        - 2.0 * (xb @ state.mu.T)
                        + torch.sum(state.mu * state.mu, dim=1)[None, :])
    else:
        d2_diag = (xb * xb) @ diag.T - 2.0 * (xb @ dmu.T) + m2[None, :]
        proxy = bias[None, :] - 0.5 * d2_diag
    proxy = torch.where(state.active[None, :], proxy,
                        torch.full_like(proxy, -torch.inf))
    idx = topc(proxy, c)                                  # (B, C)
    diff = xb[:, None, :] - state.mu[idx]                 # (B, C, D)
    y = gathered_products(state.lam, diff, idx)
    d2 = torch.einsum("bcd,bcd->bc", diff, y)
    logp = -0.5 * (cfg.dim * _LOG_2PI + state.logdet[idx] + d2)
    logjoint = torch.where(state.active[idx], logp + logprior[idx],
                           torch.full_like(logp, -torch.inf))
    return idx, d2, logjoint


def chunk_stats_sparse(cfg: FIGMNConfig, state: FIGMNState, xc: Tensor,
                       thresh: float) -> Tuple[Tensor, Tensor]:
    """Shortlisted twin of ``stream.ingest.chunk_stats``: (fails (B,) bool,
    mean mixture log-likelihood ()) with the (B, K) Mahalanobis sweep
    truncated to the top-C rows; the gate sees the shortlist, as
    ``learn_one_sparse`` does."""
    c = min(int(cfg.shortlist_c), int(state.active.shape[0]))
    xc = xc.to(cfg.dtype)
    idx, d2, logjoint = _topc_exact_batch(cfg, state, _bound_caches(state),
                                          xc, c)
    fails = ~torch.any(state.active[idx] & (d2 < thresh), dim=1)
    return fails, torch.logsumexp(logjoint, dim=1).mean()
