"""CUDA kernel: batched squared Mahalanobis distance (paper eq. 22), with
its plain version beside it.

Replaces ``repro/kernels/mahalanobis.py::mahalanobis_pallas``:
d²_k = diff_kᵀ Λ_k diff_k for K components in one pass over Λ.  Bound:
K·D²·4 bytes read.  One block per component reduces in a fixed order (no
float atomics), so repeated runs are bit-equal.  As in the reference, no
runtime path calls it; ``ops.mahalanobis_sq`` and the tests do.

Source: ``csrc/mahalanobis.cu``.  Plain version: ``ref.mahalanobis_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mahalanobis_ref

Tensor = torch.Tensor

mahalanobis_plain = mahalanobis_ref


def mahalanobis(diff: Tensor, lam: Tensor) -> Tensor:
    """diff (K, D), lam (K, D, D) float32 → (K,) float32."""
    k, d = diff.shape
    dev = diff.device
    _build.check_tensor("diff", diff, (k, d), dev)
    _build.check_tensor("lam", lam, (k, d, d), dev)
    if not _build.on_cuda(dev):
        return mahalanobis_plain(diff, lam)
    _build.check_smem_vector(d)
    out = torch.empty((k,), dtype=torch.float32, device=dev)
    if k:
        if d == 0:
            return out.zero_()
        err = _build.lib().figmn_mahalanobis(
            diff.data_ptr(), lam.data_ptr(), out.data_ptr(), k, d,
            _build.stream_ptr(diff))
        _build.check(err, "mahalanobis")
        _build.LAUNCHES["mahalanobis"] += 1
    return out
