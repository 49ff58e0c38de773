"""CUDA kernels for the FIGMN precision update (eqs. 20–21), with their
plain versions beside them.

Replaces ``repro/kernels/figmn_update.py``:

  ``matvec2``     ← ``matvec2_pallas``: (y, z) = (Λa, Λb) for all K slots in
                  one pass over Λ (or y = Λa alone, the gate/update matvec
                  of the fused step).  Bound: K·D²·4 bytes read.
  ``rank2_apply`` ← ``rank2_apply_pallas``: Λ' = Λ·inv1mw − c1·yyᵀ
                  + c2·yb ybᵀ without materialising the outer products.
                  Bound: 2·K·D²·4 bytes (one read, one write of Λ).

Sources: ``csrc/figmn_update.cu``.  A wrapper launches its kernel for a
CUDA tensor and raises if the launch fails; it takes the plain version
only for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matvec_ref, rank2_apply_ref

Tensor = torch.Tensor

matvec2_plain = matvec_ref
rank2_apply_plain = rank2_apply_ref


def matvec2(lam: Tensor, a: Tensor, b: Optional[Tensor] = None
            ) -> Tuple[Tensor, Optional[Tensor]]:
    """(Λa, Λb) for every slot: lam (K, D, D), a, b (K, D) float32.  With
    ``b`` None only y = Λa is computed (z is None)."""
    k, d = a.shape
    dev = lam.device
    _build.check_tensor("lam", lam, (k, d, d), dev)
    _build.check_tensor("a", a, (k, d), dev)
    _build.check_tensor("b", b, (k, d), dev)
    if not _build.on_cuda(dev):
        return matvec2_plain(lam, a), \
            (matvec2_plain(lam, b) if b is not None else None)
    y = torch.empty_like(a)
    z = torch.empty_like(b) if b is not None else None
    if k and d:
        err = _build.lib().figmn_matvec2(
            lam.data_ptr(), a.data_ptr(),
            b.data_ptr() if b is not None else None, y.data_ptr(),
            z.data_ptr() if z is not None else None, k, d,
            _build.stream_ptr(lam))
        _build.check(err, "matvec2")
        _build.LAUNCHES["matvec2"] += 1
    return y, z


def rank2_apply(lam: Tensor, y: Tensor, yb: Optional[Tensor],
                inv1mw: Tensor, c1: Tensor, c2: Optional[Tensor],
                out: Optional[Tensor] = None) -> Tensor:
    """Λ·inv1mw − c1·yyᵀ (+ c2·yb ybᵀ) for every slot.

    lam (K, D, D); y, yb (K, D); inv1mw, c1, c2 (K,), all float32.  ``yb``
    and ``c2`` None drop the second term.  ``out`` may be ``lam`` itself:
    each element is read and written by one thread, so the update runs in
    place and saves a K·D² allocation per point (the TPU path donated the
    buffer instead).
    """
    k, d = y.shape
    dev = lam.device
    if (yb is None) != (c2 is None):
        raise ValueError("yb and c2 are given together or not at all")
    _build.check_tensor("lam", lam, (k, d, d), dev)
    _build.check_tensor("y", y, (k, d), dev)
    _build.check_tensor("yb", yb, (k, d), dev)
    for name, t in (("inv1mw", inv1mw), ("c1", c1), ("c2", c2)):
        _build.check_tensor(name, t, (k,), dev)
    _build.check_tensor("out", out, (k, d, d), dev)
    if not _build.on_cuda(dev):
        res = rank2_apply_plain(lam, y, yb, inv1mw, c1, c2)
        return out.copy_(res) if out is not None else res
    if out is None:
        out = torch.empty_like(lam)
    if k and d:
        err = _build.lib().figmn_rank2_apply(
            lam.data_ptr(), y.data_ptr(),
            yb.data_ptr() if yb is not None else None, inv1mw.data_ptr(),
            c1.data_ptr(), c2.data_ptr() if c2 is not None else None,
            out.data_ptr(), k, d, _build.stream_ptr(lam))
        _build.check(err, "rank2_apply")
        _build.LAUNCHES["rank2_apply"] += 1
    return out
