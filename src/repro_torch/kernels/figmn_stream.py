"""CUDA kernel: the resident streaming FIGMN fit, with its plain version.

Replaces ``repro/kernels/figmn_stream.py::figmn_stream_pallas``.  On the TPU
the whole (K, D, D) working set sat in VMEM for a chunk; on Hopper it sits
in one block's dynamic shared memory (227 KB per block on H100, queried
from the device), so device memory sees only the x_t rows.  One launch runs
a whole chunk: per point the matvec, d², chi² gate, the kernel's own masked
posterior, the sp/μ update, the exact fused rank-one update and logdet, and
an accept counter.  Gate-failing points are no-ops; creation is the
caller's business (``stream.ingest.fit_chunk_vmem``).

Bound: with the state on chip the work is ≈ 6·K·D² flops per point, but a
single block uses one SM, so the kernel runs far below the card's rate; a
cluster or multi-block design is later work.

Source: ``csrc/figmn_stream.cu``.  Plain version: ``ref.figmn_stream_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _LOG_2PI, figmn_stream_ref

Tensor = torch.Tensor

figmn_stream_plain = figmn_stream_ref


def smem_bytes(k: int, d: int) -> int:
    """Shared memory the kernel holds for a (K, D) pool: Λ (K·D²), μ, diff
    and y (K·D each), seven (K,) vectors and x (D), all float32 — the
    layout of ``csrc/figmn_stream.cu`` (``figmn_stream_smem_bytes``)."""
    return 4 * (k * d * d + 3 * k * d + 7 * k + d)


def figmn_stream(xs: Tensor, mu: Tensor, lam: Tensor, logdet: Tensor,
                 sp: Tensor, active: Tensor, thresh: float, dim: int
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Run the chunk ``xs`` (N, D) with the state held on chip.

    mu (K, D), lam (K, D, D), logdet/sp (K,) float32; active (K,) int32;
    ``thresh`` the float32 gate as a Python float.  Returns new
    (mu, lam, logdet, sp) and the accept count (1,) int32, left on the
    device.  Raises when the working set exceeds the device's per-block
    opt-in shared memory.
    """
    n, d = xs.shape
    k = mu.shape[0]
    dev = xs.device
    _build.check_tensor("xs", xs, (n, d), dev)
    for name, t, shape in (("mu", mu, (k, d)), ("lam", lam, (k, d, d)),
                           ("logdet", logdet, (k,)), ("sp", sp, (k,))):
        _build.check_tensor(name, t, shape, dev)
    _build.check_index("active", active, (k,), dev)
    if not _build.on_cuda(dev):
        return figmn_stream_plain(xs, mu, lam, logdet, sp, active, thresh,
                                  dim)
    need, limit = smem_bytes(k, d), _build.smem_optin(dev)
    if need > limit:
        raise ValueError(
            f"resident working set of {need} bytes (K={k}, D={d}) exceeds "
            f"the {limit} bytes of shared memory a block may use on {dev}")
    outs = (torch.empty_like(mu), torch.empty_like(lam),
            torch.empty_like(logdet), torch.empty_like(sp))
    nacc = torch.zeros((1,), dtype=torch.int32, device=dev)
    if n:
        err = _build.lib().figmn_stream(
            xs.data_ptr(), n, mu.data_ptr(), lam.data_ptr(),
            logdet.data_ptr(), sp.data_ptr(), active.data_ptr(),
            float(thresh), dim * _LOG_2PI, float(dim),
            *(o.data_ptr() for o in outs), nacc.data_ptr(), k, d,
            _build.stream_ptr(xs))
        _build.check(err, "figmn_stream")
        _build.LAUNCHES["figmn_stream"] += 1
    else:
        for o, src in zip(outs, (mu, lam, logdet, sp)):
            o.copy_(src)
    return (*outs, nacc)
