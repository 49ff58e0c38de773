"""Core datatypes for the (Fast) Incremental Gaussian Mixture Network.

PyTorch counterpart of ``repro.core.types``: the same fixed-capacity pool of
``kmax`` component slots plus an ``active`` mask, held as a dataclass of
tensors on an explicit device.  Creating a component activates the first
free slot; pruning deactivates a slot; a full pool recycles the weakest
(lowest ``sp``) component.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no device given and no CUDA card present this raises —
    the port never carries on silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class FIGMNConfig:
    """Static configuration (hyper-parameters from §2 of the paper).

    Same fields and defaults as ``repro.core.types.FIGMNConfig``, so one
    config dict drives both packages.

    beta:  novelty meta-parameter; update iff some component has squared
           Mahalanobis distance below the chi²_{D,1-beta} percentile.
    delta: scaling factor for the initial standard deviation (eq. 13).
    vmin/spmin: pruning thresholds (§2.3).
    update_mode: "paper" (eq. 11 verbatim, two rank-one updates) or
           "exact" (the PSD-preserving single rank-one recursion).
    backend: "pallas" selects the hand-written CUDA kernels
           (``kernels.ops``); "jnp" selects plain torch ops.  The names are
           the reference's, kept so one config dict drives both packages.
    fused: share the distance-pass matvec with the update (2 passes over Λ
           per point instead of 4; see ``figmn.fused_step_coeffs``).
    shortlist_c / shortlist_mode: the top-C shortlist; not ported yet, so
           only ``shortlist_c == 0`` is accepted by the entry points.
    sigma_ini: per-dimension initial std (eq. 13): a float, a numpy array
           or a tensor.
    """
    kmax: int = 32
    dim: int = 2
    beta: float = 0.1
    delta: float = 0.01
    vmin: float = 5.0
    spmin: float = 3.0
    dtype_str: str = "float32"
    update_mode: str = "paper"
    backend: str = "jnp"
    fused: bool = True
    shortlist_c: int = 0
    shortlist_mode: str = "diag"
    sigma_ini: Any = None

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_str)


@dataclasses.dataclass
class FIGMNState:
    """Mixture state (precision form), every field on one device.

    mu:      (K, D)    component means
    lam:     (K, D, D) precision matrices  Λ = C⁻¹
    logdet:  (K,)      log |C| (the canonical determinant track)
    sp:      (K,)      posterior-probability accumulators
    v:       (K,)      component ages
    active:  (K,)      slot occupancy mask (bool)
    n_created: ()      total components ever created (int32)
    """
    mu: Tensor
    lam: Tensor
    logdet: Tensor
    sp: Tensor
    v: Tensor
    active: Tensor
    n_created: Tensor

    @property
    def det(self) -> Tensor:
        """|C| derived from the canonical log|C| track."""
        return torch.exp(self.logdet)

    @property
    def n_active(self) -> Tensor:
        return self.active.sum(dtype=torch.int32)

    @property
    def device(self) -> torch.device:
        return self.mu.device

    def clone(self) -> "FIGMNState":
        """A deep copy.  The learning steps may write Λ in place (the
        reference donates the buffer instead), so a caller that needs the
        input state afterwards passes a clone."""
        return FIGMNState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class IGMNState:
    """Mixture state for the covariance-form baseline (original IGMN)."""
    mu: Tensor
    cov: Tensor
    sp: Tensor
    v: Tensor
    active: Tensor
    n_created: Tensor

    @property
    def n_active(self) -> Tensor:
        return self.active.sum(dtype=torch.int32)


def chi2_quantile(dof: int, p, device: Optional[torch.device] = None
                  ) -> Tensor:
    """chi²_{dof, p} via the Wilson–Hilferty approximation, in float32.

    The novelty gate ``d² < thresh`` flips on one last bit, so every step is
    taken in float32 in the reference's order.  p → 1 gives +inf (the
    paper's beta = 0 single-component experiments).
    """
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    z = torch.special.ndtri(p)
    k = torch.as_tensor(dof, dtype=torch.float32, device=device)
    b = 1.0 - 2.0 / (9.0 * k) + z * torch.sqrt(2.0 / (9.0 * k))
    return k * (b * b * b)      # jnp's integer power: b·(b·b), no powf


def gate_threshold(cfg: FIGMNConfig) -> float:
    """The chi² gate as a Python float holding the float32 value exactly,
    so comparing a float32 tensor against it compares in float32."""
    return float(chi2_quantile(cfg.dim, 1.0 - cfg.beta).to(cfg.dtype))
