"""CUDA kernels for the top-C shortlist path, with their plain versions
beside them.

Replaces ``repro/kernels/figmn_sparse.py``:

  ``gathered_matvec`` ← ``gathered_matvec_pallas``: y_c = Λ[idx_c]·diff_c
                      for the C shortlisted rows, reading C·D² (not K·D²)
                      of Λ and never copying the gathered rows out.  Bound:
                      C·D²·4 bytes read.
  ``scatter_apply``   ← ``scatter_apply_pallas``: Λ[idx_c] ← Λ[idx_c]·a_c
                      − (b_c·y_c,i)·y_c,j IN PLACE; the K − C other rows
                      are never touched, so they stay bit-identical.
                      Bound: 2·C·D²·4 bytes (one read, one write).

Each block reads its index from device memory (the TPU kernels prefetched
them as scalars), so no host round-trip.  Shortlist indices are unique, so
the in-place write is race-free.  Sources: ``csrc/figmn_sparse.cu``.  A
wrapper launches its kernel for a CUDA tensor and raises if the launch
fails; it takes the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gathered_matvec_ref, scatter_apply_ref

Tensor = torch.Tensor

gathered_matvec_plain = gathered_matvec_ref
scatter_apply_plain = scatter_apply_ref


def gathered_matvec(lam: Tensor, diff: Tensor, idx: Tensor) -> Tensor:
    """y_c = Λ[idx_c]·diff_c: lam (K, D, D), diff (C, D) float32, idx (C,)
    int32 → (C, D).  C may be any number of (point, slot) pairs."""
    c, d = diff.shape
    k = lam.shape[0]
    dev = lam.device
    _build.check_tensor("lam", lam, (k, d, d), dev)
    _build.check_tensor("diff", diff, (c, d), dev)
    _build.check_index("idx", idx, (c,), dev)
    if not _build.on_cuda(dev):
        return gathered_matvec_plain(lam, diff, idx)
    _build.check_smem_vector(d)
    y = torch.empty_like(diff)
    if c and d:
        err = _build.lib().figmn_gathered_matvec(
            lam.data_ptr(), diff.data_ptr(), idx.data_ptr(), y.data_ptr(),
            c, d, k, _build.stream_ptr(lam))
        _build.check(err, "gathered_matvec")
        _build.LAUNCHES["gathered_matvec"] += 1
    return y


def scatter_apply(lam: Tensor, y: Tensor, coefs: Tensor, idx: Tensor
                  ) -> Tensor:
    """Λ[idx_c] ← Λ[idx_c]·coefs[c, 0] − (coefs[c, 1]·y_c,i)·y_c,j in
    place: lam (K, D, D), y (C, D), coefs (C, 2) float32, idx (C,) int32
    with unique entries.  Returns ``lam``."""
    c, d = y.shape
    k = lam.shape[0]
    dev = lam.device
    _build.check_tensor("lam", lam, (k, d, d), dev)
    _build.check_tensor("y", y, (c, d), dev)
    _build.check_tensor("coefs", coefs, (c, 2), dev)
    _build.check_index("idx", idx, (c,), dev)
    if not _build.on_cuda(dev):
        return scatter_apply_plain(lam, y, coefs, idx)
    if c and d:
        err = _build.lib().figmn_scatter_apply(
            lam.data_ptr(), y.data_ptr(), coefs.data_ptr(), idx.data_ptr(),
            c, d, k, _build.stream_ptr(lam))
        _build.check(err, "scatter_apply")
        _build.LAUNCHES["scatter_apply"] += 1
    return lam
