"""CUDA kernel: flash-attention forward, with its plain version beside it.

Replaces ``repro/kernels/flash_attention.py::_flash_fwd_flat``
(``_flash_kernel``): online-softmax attention with a causal mask, a
sliding window given at run time (≤ 0: full) and keys at ``k_pos < 0``
hidden, returning the output and the row log-sum-exp.  Bound by
operations at the full config (4·d per visible (query, key) pair).  The
backward kernels (``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``) are
not ported yet: inference needs the forward only.

Source: ``csrc/flash_attention.cu``.  Plain version: ``ref.flash_fwd_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_fwd_ref, flash_scale

Tensor = torch.Tensor

flash_fwd_plain = flash_fwd_ref

MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
              window: int, causal: bool = True) -> Tuple[Tensor, Tensor]:
    """q (B, T, H, d); k, v (B, S, KV, d) with H a multiple of KV (query
    head h reads KV head h // (H / KV), so GQA needs no expanded copy);
    float32 or bfloat16, one type for all three; q_pos (B, T), k_pos
    (B, S) int32; window an int (≤ 0: full).  → out (B, T, H, d) in q's
    type, lse (B, H, T) float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, and a failed build or launch raises."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dev = q.device
    _build.check_tensor("q", q, (b, t, h, d), dev, _DTYPES)
    _build.check_tensor("k", k, (b, s, kvh, d), dev, (q.dtype,))
    _build.check_tensor("v", v, (b, s, kvh, d), dev, (q.dtype,))
    _build.check_index("q_pos", q_pos, (b, t), dev)
    _build.check_index("k_pos", k_pos, (b, s), dev)
    if kvh < 1 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if s < 1:
        raise ValueError("attention needs at least one key")
    window = int(window)
    if not _build.on_cuda(dev):
        return flash_fwd_plain(q, k, v, q_pos, k_pos, window, causal)
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    if b * h > 65535:
        raise ValueError(f"B·H = {b * h} exceeds the grid's 65535")
    lib = _build.lib()
    need = lib.figmn_flash_fwd_smem_bytes(d)
    if need > _build.smem_optin(dev):
        raise ValueError(f"head_dim {d} needs {need} B of shared memory, "
                         "more than a block may hold")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    if t:
        err = lib.figmn_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, s, h, kvh,
            d, window, int(causal), flash_scale(d),
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
        _build.check(err, "flash_fwd")
        _build.LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                    k_pos: Tensor, window: int, *, causal: bool = True,
                    block_q: int = 512, block_k: int = 512,
                    interpret: bool = False) -> Tensor:
    """The reference's signature and shapes: q (B, T, H, d), k/v
    (B, S, H, d) (or (B, S, KV, d), H a multiple of KV), i32 positions,
    window an int (≤ 0: full) → (B, T, H, d).  ``block_q``, ``block_k``
    and ``interpret`` are the reference's TPU tiling and interpret-mode
    switches: accepted and ignored (the kernel tiles 64 × 64 and masks its
    ragged edges; the CPU takes the plain version)."""
    del block_q, block_k, interpret
    return flash_fwd(q, k, v, q_pos, k_pos, window, causal)[0]
