"""Plain PyTorch versions of every kernel in this package.

Each function is the mathematical definition the corresponding CUDA kernel
must reproduce: the CPU tests hold these against the JAX reference
(``repro.kernels.ref`` and the Pallas kernels in interpret mode), and
``chip_smoke.py`` holds each CUDA kernel against its plain version on the
card.  The wrappers take these versions only for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453


def mahalanobis_ref(diff: Tensor, lam: Tensor) -> Tensor:
    """d²_k = diff_kᵀ Λ_k diff_k  (eq. 22 batched over K).

    diff: (K, D), lam: (K, D, D) → (K,)
    """
    return torch.einsum("kd,kde,ke->k", diff, lam, diff)


def matvec_ref(lam: Tensor, v: Tensor) -> Tensor:
    """y_k = Λ_k v_k for every slot.  lam: (K, D, D), v: (K, D) → (K, D)."""
    return torch.einsum("kde,ke->kd", lam, v)


def figmn_matvecs_ref(lam: Tensor, e_star: Tensor,
                      dmu: Tensor) -> Tuple[Tensor, Tensor]:
    """The two matvecs of the rank-2 precision update: y = Λe*, z = ΛΔμ."""
    return matvec_ref(lam, e_star), matvec_ref(lam, dmu)


def gathered_matvec_ref(lam: Tensor, diff: Tensor, idx: Tensor) -> Tensor:
    """y_c = Λ[idx_c]·diff_c for the C shortlisted rows.

    lam: (K, D, D), diff: (C, D), idx: (C,) integer → (C, D).  Gathers the
    C rows (C·D² floats) before the product; the kernel does not.
    """
    return torch.einsum("kde,ke->kd", lam[idx.long()], diff)


def scatter_apply_ref(lam: Tensor, y: Tensor, coefs: Tensor,
                      idx: Tensor) -> Tensor:
    """Λ[idx_c] ← Λ[idx_c]·a_c − (b_c·y_c,i)·y_c,j IN PLACE, in the TPU
    kernel's association; the K − C other rows are not touched.

    lam: (K, D, D); y: (C, D); coefs: (C, 2) = (a, b); idx: (C,) unique
    integers.  Returns ``lam``.
    """
    i = idx.long()
    a, b = coefs[:, 0], coefs[:, 1]
    rows = lam[i] * a[:, None, None] \
        - (b[:, None] * y)[:, :, None] * y[:, None, :]
    return lam.index_copy_(0, i, rows)


def rank2_apply_ref(lam: Tensor, y: Tensor, yb: Optional[Tensor],
                    inv1mw: Tensor, c1: Tensor,
                    c2: Optional[Tensor]) -> Tensor:
    """Λ' = Λ·inv1mw − c1·yyᵀ + c2·yb ybᵀ, in the TPU kernel's association:
    ((Λ·inv1mw) − (c1·y_i)·y_j) + (c2·yb_i)·yb_j.

    lam: (K, D, D); y, yb: (K, D); inv1mw, c1, c2: (K,).  ``yb``/``c2``
    None drops the second term (the reference feeds zeros there, which
    adds exactly 0).
    """
    out = lam * inv1mw[:, None, None] \
        - (c1[:, None] * y)[:, :, None] * y[:, None, :]
    if yb is not None:
        out = out + (c2[:, None] * yb)[:, :, None] * yb[:, None, :]
    return out


def precision_rank2_update_ref(lam: Tensor, e_star: Tensor, dmu: Tensor,
                               w: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """End-to-end oracle for the paper's eqs. 20–21 (precision part only).

    Returns (Λ(t), s, t) where s = e*ᵀΛe* and t = ΔμᵀΛ̄Δμ feed the
    determinant-lemma updates (eqs. 25–26).
    """
    one_m_w = 1.0 - w
    y, z = figmn_matvecs_ref(lam, e_star, dmu)
    s = torch.einsum("kd,kd->k", e_star, y)
    denom1 = 1.0 + w * s / one_m_w
    c1 = w / (one_m_w * one_m_w * denom1)
    u = torch.einsum("kd,kd->k", y, dmu)                 # yᵀΔμ
    yb = z / one_m_w[:, None] - (c1 * u)[:, None] * y    # Λ̄Δμ without Λ̄
    t = torch.einsum("kd,kd->k", dmu, z) / one_m_w - c1 * u * u
    c2 = 1.0 / (1.0 - t)
    lam_new = rank2_apply_ref(lam, y, yb, 1.0 / one_m_w, c1, c2)
    return lam_new, s, t


def precision_rank1_update_exact_ref(lam: Tensor, e: Tensor,
                                     w: Tensor) -> Tuple[Tensor, Tensor]:
    """Oracle for the beyond-paper exact mode: Λ' = (Λ − c·yyᵀ)/(1−ω)."""
    one_m_w = 1.0 - w
    y = matvec_ref(lam, e)
    s = torch.einsum("kd,kd->k", e, y)
    coef = w / (1.0 + w * s)
    lam_new = (lam - coef[:, None, None] * torch.einsum("kd,ke->kde", y, y)) \
        / one_m_w[:, None, None]
    return lam_new, s


def figmn_stream_ref(xs: Tensor, mu: Tensor, lam: Tensor, logdet: Tensor,
                     sp: Tensor, active: Tensor, thresh: float, dim: int
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The resident chunk loop: every point of ``xs`` (N, D) through the
    gate, the kernel's own masked posterior and the exact-mode fused
    rank-one update, in the TPU kernel's order of operations
    (``repro.kernels.figmn_stream._stream_kernel``).

    Gate-failing points are no-ops (creation is the caller's business).
    Returns new (mu, lam, logdet, sp) and the accept count (1,) int32.
    """
    active = active.bool()
    mu, lam, logdet, sp = mu.clone(), lam.clone(), logdet.clone(), sp.clone()
    nacc = torch.zeros((1,), dtype=torch.int32, device=xs.device)
    log_norm = dim * _LOG_2PI
    for t in range(xs.shape[0]):
        diff = xs[t][None, :] - mu                              # (K, D)
        y = matvec_ref(lam, diff)                               # (K, D)
        d2 = (diff * y).sum(dim=1)                              # (K,)
        accept = torch.any(active & (d2 < thresh))
        logp = -0.5 * (log_norm + logdet + d2)
        logw = torch.where(active, logp + torch.log(sp.clamp_min(1e-30)),
                           torch.full_like(logp, -1e30))
        p_un = torch.where(active, torch.exp(logw - logw.max()),
                           torch.zeros_like(logw))
        post = p_un / p_un.sum().clamp_min(1e-30)
        post = torch.where(accept, post, torch.zeros_like(post))
        sp_new = sp + post
        w = post / sp_new.clamp_min(1e-30)
        one_m_w = 1.0 - w
        beta = w / (1.0 + w * d2)
        dlogdet = dim * torch.log(one_m_w) + torch.log1p(w * d2)
        mu = mu + w[:, None] * diff
        lam = (lam - (beta[:, None] * y)[:, None, :] * y[:, :, None]) \
            / one_m_w[:, None, None]
        logdet = logdet + dlogdet
        sp = sp_new
        nacc += accept.to(torch.int32)
    return mu, lam, logdet, sp, nacc


FLASH_NEG = -1e30          # the masked logit (never -inf: no row turns NaN)


def flash_scale(d: int) -> float:
    """The logit scale 1/sqrt(d) as the float32 value both the reference
    kernel and ``csrc/flash_attention.cu`` multiply by (after the dot)."""
    return float(np.float32(1.0 / (d ** 0.5)))


def flash_fwd_ref(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                  k_pos: Tensor, window: int, causal: bool = True
                  ) -> Tuple[Tensor, Tensor]:
    """Attention with the arithmetic of the reference's ``_flash_kernel``,
    over all keys at once.

    q: (B, T, H, d); k, v: (B, S, KV, d) with H a multiple of KV (query
    head h reads KV head h // (H / KV)); q_pos (B, T), k_pos (B, S) int32;
    window an int, ≤ 0 for full attention.  Returns out (B, T, H, d) in
    q's dtype and lse (B, H, T) float32.

    q and k go to float32 and the scale multiplies the dot; a key is
    visible iff k_pos ≥ 0, (causal) q_pos − k_pos ≥ 0 and (window ≤ 0 or
    q_pos − k_pos < window); hidden logits are −1e30; p = exp(logit − m)
    is summed in float32 for l and rounded to v's dtype before the PV
    product, which accumulates in float32; out = acc / max(l, 1e-30) in
    q's dtype, lse = m + log(max(l, 1e-30)).  A row that sees no key has
    m = −1e30 and p = 1 on every key: out is the mean of v over the S keys.
    One head at a time, so the (B, T, S) logits are the largest transient.
    """
    b, t, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = flash_scale(d)
    mask = flash_mask(q_pos, k_pos, window, causal)               # (B, T, S)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    for hh in range(h):
        kh = hh // g
        logits = torch.einsum("btd,bsd->bts", q[:, :, hh].float(),
                              k[:, :, kh].float()) * scale
        logits = torch.where(mask, logits, FLASH_NEG)
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])
        l = p.sum(dim=-1)
        acc = torch.einsum("bts,bsd->btd", p.to(v.dtype).float(),
                           v[:, :, kh].float())
        lc = torch.clamp_min(l, 1e-30)
        out[:, :, hh] = (acc / lc[..., None]).to(q.dtype)
        lse[:, hh] = m + torch.log(lc)
    return out, lse


def flash_mask(q_pos: Tensor, k_pos: Tensor, window: int,
               causal: bool) -> Tensor:
    """(B, T, S) bool: key s is visible to query t iff k_pos ≥ 0, (causal)
    q_pos − k_pos ≥ 0 and (window ≤ 0 or q_pos − k_pos < window)."""
    dpos = q_pos[:, :, None] - k_pos[:, None, :]
    mask = (k_pos >= 0)[:, None, :].expand(dpos.shape)
    if causal:
        mask = mask & (dpos >= 0)
    if window > 0:
        mask = mask & (dpos < window)
    return mask


def flash_delta(out: Tensor, dout: Tensor) -> Tensor:
    """δ = rowsum(dO ∘ O) in float32, (B, H, T) like lse: formed outside
    the backward kernels, as the reference forms it."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def _flash_p_ds(qh, kh, vh, doh, lse_h, delta_h, mask, scale):
    """One query head's p = exp(scale·qkᵀ − lse) under the mask (0 where
    hidden) and ds = p ∘ (dO·vᵀ − δ), both (B, T, S) float32."""
    logits = torch.einsum("btd,bsd->bts", qh.float(), kh.float()) * scale
    p = torch.where(mask, torch.exp(logits - lse_h[..., None]), 0.0)
    dp = torch.einsum("btd,bsd->bts", doh.float(), vh.float())
    return p, p * (dp - delta_h[..., None])


def flash_bwd_dq_ref(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                     k_pos: Tensor, dout: Tensor, lse: Tensor, delta: Tensor,
                     window: int, causal: bool = True) -> Tensor:
    """dq = scale·Σ_j ds_ij k_j with the arithmetic of the reference's
    ``_flash_bwd_dq_kernel``: q, k, v and dO read as float32, p recomputed
    from lse in float32 (not rounded: the forward rounds p before PV, the
    backward does not) and 0 where the key is hidden, so a row that sees
    no key gets dq = 0.  The scale multiplies the summed dot (the reference
    multiplies each tile's dot: the same terms).

    q, dout (B, T, H, d); k, v (B, S, KV, d), query head h reading KV head
    h // (H / KV); lse, delta (B, H, T) float32.  → dq in q's dtype."""
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    scale = flash_scale(q.shape[-1])
    mask = flash_mask(q_pos, k_pos, window, causal)
    dq = torch.empty_like(q)
    for hh in range(h):
        kh, vh = k[:, :, hh // g], v[:, :, hh // g]
        _, ds = _flash_p_ds(q[:, :, hh], kh, vh, dout[:, :, hh], lse[:, hh],
                            delta[:, hh], mask, scale)
        dq[:, :, hh] = (torch.einsum("bts,bsd->btd", ds, kh.float())
                        * scale).to(q.dtype)
    return dq


def flash_bwd_dkv_ref(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                      k_pos: Tensor, dout: Tensor, lse: Tensor,
                      delta: Tensor, window: int, causal: bool = True
                      ) -> Tuple[Tensor, Tensor]:
    """dv = Σ_i p_ij dO_i and dk = scale·Σ_i ds_ij q_i with the arithmetic
    of the reference's ``_flash_bwd_dkv_kernel`` (p and ds as in
    ``flash_bwd_dq_ref``).  KV head j's dk and dv sum its g query heads in
    order h = j·g … j·g + g − 1, in float32, and round once to k's and
    v's dtype (the reference expands k and v to the query heads and lets
    autodiff sum the group).  Shapes as ``flash_bwd_dq_ref``; → dk, dv
    (B, S, KV, d)."""
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    scale = flash_scale(q.shape[-1])
    mask = flash_mask(q_pos, k_pos, window, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j in range(kvh):
        acc_k = acc_v = 0.0
        for hh in range(j * g, (j + 1) * g):
            qh, doh = q[:, :, hh], dout[:, :, hh]
            p, ds = _flash_p_ds(qh, k[:, :, j], v[:, :, j], doh, lse[:, hh],
                                delta[:, hh], mask, scale)
            acc_v = acc_v + torch.einsum("bts,btd->bsd", p, doh.float())
            acc_k = acc_k + torch.einsum("bts,btd->bsd", ds, qh.float())
        dk[:, :, j] = (acc_k * scale).to(k.dtype)
        dv[:, :, j] = acc_v.to(v.dtype)
    return dk, dv


def flash_bwd_ref(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                  k_pos: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
                  window: int, causal: bool = True
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """The gradient of ``flash_fwd_ref``'s out as the reference's backward
    kernels define it — not autograd of ``flash_fwd_ref``, which differs
    where the forward rounds p and where a row sees no key (there the
    forward's out is the mean of v; the backward gives that row nothing).
    out, lse: the forward's; dout (B, T, H, d).  → dq, dk, dv."""
    delta = flash_delta(out, dout)
    dq = flash_bwd_dq_ref(q, k, v, q_pos, k_pos, dout, lse, delta, window,
                          causal)
    dk, dv = flash_bwd_dkv_ref(q, k, v, q_pos, k_pos, dout, lse, delta,
                               window, causal)
    return dq, dk, dv
