"""Public wrappers around the CUDA kernels (``backend="pallas"``).

Counterpart of ``repro/kernels/ops.py``, without its padding of D to 128
lanes: that is a TPU layout rule, and at D = 794 it would copy the whole
(K, D, D) Λ twice per point.  The kernels mask the ragged edge instead.
The O(K·D) scalar work between the two kernels is plain torch.

Every function here updates Λ IN PLACE (the returned Λ is the input
buffer): the reference donated the buffer to XLA, the port writes into it,
which saves a K·D² allocation per point.  Callers that need the old Λ pass
a clone.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import figmn_sparse, mahalanobis
from repro_torch.kernels.figmn_update import matvec2, rank2_apply

Tensor = torch.Tensor


def mahalanobis_sq(diff: Tensor, lam: Tensor) -> Tensor:
    """(K, D), (K, D, D) → (K,) squared Mahalanobis distances."""
    return mahalanobis.mahalanobis(diff, lam)


def matvec(lam: Tensor, diff: Tensor) -> Tensor:
    """y = Λ·diff for all K slots (the shared distance/update pass)."""
    y, _ = matvec2(lam, diff)
    return y


def precision_rank2_update(lam: Tensor, logdet: Tensor, e_star: Tensor,
                           dmu: Tensor, w: Tensor, dim: int
                           ) -> Tuple[Tensor, Tensor]:
    """Kernel path of ``core.figmn.precision_rank2_update`` (eqs. 20–21 /
    25–26): one matvec2 pass, O(K·D) scalars, one rank2_apply pass."""
    y, z = matvec2(lam, e_star, dmu)
    one_m_w = 1.0 - w
    s = torch.einsum("kd,kd->k", e_star, y)
    denom1 = 1.0 + w * s / one_m_w
    c1 = w / (one_m_w * one_m_w * denom1)
    u = torch.einsum("kd,kd->k", y, dmu)                  # yᵀΔμ
    yb = z / one_m_w[:, None] - (c1 * u)[:, None] * y     # Λ̄Δμ without Λ̄
    t = torch.einsum("kd,kd->k", dmu, z) / one_m_w - c1 * u * u
    c2 = 1.0 / (1.0 - t)
    lam_new = rank2_apply(lam, y, yb, 1.0 / one_m_w, c1, c2, out=lam)
    logdet_new = logdet + dim * torch.log(one_m_w) \
        + torch.log(torch.abs(denom1)) + torch.log(torch.abs(1.0 - t))
    return lam_new, logdet_new


def precision_rank1_update_exact(lam: Tensor, logdet: Tensor, e: Tensor,
                                 w: Tensor, dim: int
                                 ) -> Tuple[Tensor, Tensor]:
    """Kernel path of the exact single rank-one update.  The reference
    feeds a zero second vector; the one-vector launches give the same
    numbers."""
    y = matvec(lam, e)
    one_m_w = 1.0 - w
    s = torch.einsum("kd,kd->k", e, y)
    coef = w / (1.0 + w * s)
    lam_new = rank2_apply(lam, y, None, 1.0 / one_m_w, coef / one_m_w, None,
                          out=lam)
    logdet_new = logdet + dim * torch.log(one_m_w) + torch.log1p(w * s)
    return lam_new, logdet_new


def fused_apply(lam: Tensor, logdet: Tensor, y: Tensor, d2: Tensor,
                w: Tensor, dim: int, update_mode: str = "paper"
                ) -> Tuple[Tensor, Tensor]:
    """Single-pass fused update: Λ' from the shared matvec y (see
    ``core.figmn.fused_step_coeffs``) through one rank2_apply launch."""
    from repro_torch.core.figmn import fused_step_coeffs
    beta, dlogdet = fused_step_coeffs(d2, w, dim, update_mode)
    one_m_w = 1.0 - w
    inv1mw = 1.0 / one_m_w
    c1 = beta / one_m_w if update_mode == "exact" else -beta
    lam_new = rank2_apply(lam, y, None, inv1mw, c1, None, out=lam)
    return lam_new, logdet + dlogdet


def gathered_matvec(lam: Tensor, diff_sel: Tensor, idx: Tensor) -> Tensor:
    """y_c = Λ[idx_c]·diff_c for the C shortlisted rows (reads C·D², not
    K·D², of Λ).  idx is cast to int32 here."""
    return figmn_sparse.gathered_matvec(lam, diff_sel,
                                        idx.to(torch.int32).contiguous())


def scatter_fused_apply(lam: Tensor, logdet: Tensor, idx: Tensor,
                        y_sel: Tensor, d2_sel: Tensor, w_sel: Tensor,
                        dim: int, update_mode: str = "paper"
                        ) -> Tuple[Tensor, Tensor]:
    """Shortlisted fused update: rows idx of Λ get the rank-one apply from
    the shared matvec y (``core.figmn.fused_step_coeffs``) in place; the
    K − C other rows are not touched.  logdet gets Δlog|C| added at idx in
    place (``index_add_``; the indices are unique).  Returns (Λ', logdet').

    Coefficients: exact Λ' = (Λ − β yyᵀ)/(1−ω) ⇒ a = 1/(1−ω), b = β/(1−ω);
    paper Λ' = Λ/(1−ω) + β yyᵀ ⇒ a = 1/(1−ω), b = −β.
    """
    from repro_torch.core.figmn import fused_step_coeffs
    beta, dlogdet = fused_step_coeffs(d2_sel, w_sel, dim, update_mode)
    inv1mw = 1.0 / (1.0 - w_sel)
    b = beta * inv1mw if update_mode == "exact" else -beta
    coefs = torch.stack([inv1mw, b], dim=1)                 # (C, 2)
    idx32 = idx.to(torch.int32).contiguous()
    lam_new = figmn_sparse.scatter_apply(lam, y_sel, coefs, idx32)
    logdet_new = logdet.index_add_(0, idx32, dlogdet)
    return lam_new, logdet_new
