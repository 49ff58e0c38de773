"""CUDA kernels: flash attention, forward and backward, with their plain
versions beside them and a ``torch.autograd.Function`` around the two.

Replaces ``repro/kernels/flash_attention.py``: ``_flash_fwd_flat``
(``_flash_kernel``), online-softmax attention with a causal mask, a
sliding window given at run time (≤ 0: full) and keys at ``k_pos < 0``
hidden, returning the output and the row log-sum-exp; and
``_flash_bwd_flat`` (``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``),
which recompute p from that log-sum-exp.  Bound by operations at the full
config: 4·d per visible (query, key) pair forward, 6·d for dq and 8·d for
dk and dv.

``FlashAttention`` is the reference's ``jax.custom_vjp`` (``_flash_core``):
its forward launches ``flash_fwd`` and keeps q, k, v, the positions, out
and lse; its backward launches ``flash_bwd_dq`` and ``flash_bwd_dkv``.
Without it a kernel's output, written through ctypes, would carry no
``grad_fn`` and cut the gradient of q, k and v.

Sources: ``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``.
Plain versions: ``ref.flash_fwd_ref``, ``ref.flash_bwd_dq_ref``,
``ref.flash_bwd_dkv_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_bwd_dkv_ref, flash_bwd_dq_ref,
                                     flash_delta, flash_fwd_ref, flash_scale)

Tensor = torch.Tensor

flash_fwd_plain = flash_fwd_ref

MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def _check_operands(q, k, v, q_pos, k_pos):
    """What every flash kernel takes (see ``flash_fwd``)."""
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


def _check_launch(dev, d: int, blocks_y: int, smem_bytes) -> None:
    """The limits of a launch on the card: head_dim, the grid's y extent
    and the block's shared memory against the device's opt-in limit."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    if blocks_y > 65535:
        raise ValueError(f"{blocks_y} (batch, head) blocks exceed the "
                         "grid's 65535")
    need = smem_bytes(d)
    if need > _build.smem_optin(dev):
        raise ValueError(f"head_dim {d} needs {need} B of shared memory, "
                         "more than a block may hold")


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
              window: int, causal: bool = True) -> Tuple[Tensor, Tensor]:
    """q (B, T, H, d); k, v (B, S, KV, d) with H a multiple of KV (query
    head h reads KV head h // (H / KV), so GQA needs no expanded copy);
    float32 or bfloat16, one type for all three; q_pos (B, T), k_pos
    (B, S) int32; window an int (≤ 0: full).  → out (B, T, H, d) in q's
    type, lse (B, H, T) float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, and a failed build or launch raises."""
    _check_operands(q, k, v, q_pos, k_pos)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dev = q.device
    window = int(window)
    if not _build.on_cuda(dev):
        return flash_fwd_plain(q, k, v, q_pos, k_pos, window, causal)
    lib = _build.lib()
    _check_launch(dev, d, b * h, lib.figmn_flash_fwd_smem_bytes)
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


def _check_grad_operands(q, k, v, q_pos, k_pos, dout, lse, delta):
    _check_operands(q, k, v, q_pos, k_pos)
    b, t, h, _ = q.shape
    _build.check_tensor("dout", dout, tuple(q.shape), q.device, (q.dtype,))
    _build.check_tensor("lse", lse, (b, h, t), q.device)
    _build.check_tensor("delta", delta, (b, h, t), q.device)


def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                 k_pos: Tensor, dout: Tensor, lse: Tensor, delta: Tensor,
                 window: int, causal: bool = True) -> Tensor:
    """dq of the attention ``flash_fwd`` computes: q, dout (B, T, H, d);
    k, v (B, S, KV, d), one type (float32 or bfloat16); lse and delta
    (``ref.flash_delta``) (B, H, T) float32; window, causal as the
    forward's.  → dq in q's type.  CPU tensors take the plain version;
    CUDA tensors launch the kernel, and a failed build or launch raises."""
    _check_grad_operands(q, k, v, q_pos, k_pos, dout, lse, delta)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dev = q.device
    window = int(window)
    if not _build.on_cuda(dev):
        return flash_bwd_dq_ref(q, k, v, q_pos, k_pos, dout, lse, delta,
                                window, causal)
    lib = _build.lib()
    _check_launch(dev, d, b * h, lib.figmn_flash_bwd_dq_smem_bytes)
    dq = torch.empty_like(q)
    if t:
        err = lib.figmn_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, t, s, h, kvh, d, window,
            int(causal), flash_scale(d), int(q.dtype == torch.bfloat16),
            _build.stream_ptr(q))
        _build.check(err, "flash_bwd_dq")
        _build.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                  k_pos: Tensor, dout: Tensor, lse: Tensor, delta: Tensor,
                  window: int, causal: bool = True) -> Tuple[Tensor, Tensor]:
    """dk and dv, operands as ``flash_bwd_dq``'s: KV head j sums its g
    query heads in one fixed order (deterministic: no atomics).  → dk, dv
    (B, S, KV, d) in k's type.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, and a failed build or launch raises."""
    _check_grad_operands(q, k, v, q_pos, k_pos, dout, lse, delta)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dev = q.device
    window = int(window)
    if not _build.on_cuda(dev):
        return flash_bwd_dkv_ref(q, k, v, q_pos, k_pos, dout, lse, delta,
                                 window, causal)
    lib = _build.lib()
    _check_launch(dev, d, b * kvh, lib.figmn_flash_bwd_dkv_smem_bytes)
    if not t:
        return torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.figmn_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, t, s, h, kvh, d, window,
        int(causal), flash_scale(d), int(q.dtype == torch.bfloat16),
        _build.stream_ptr(q))
    _build.check(err, "flash_bwd_dkv")
    _build.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
              out: Tensor, lse: Tensor, dout: Tensor, window: int,
              causal: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) from the forward's out and lse and the gradient dout
    of out: δ = rowsum(dO ∘ O) by a plain op, then ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` (the reference's ``_flash_bwd_flat``)."""
    delta = flash_delta(out, dout)
    dq = flash_bwd_dq(q, k, v, q_pos, k_pos, dout, lse, delta, window,
                      causal)
    dk, dv = flash_bwd_dkv(q, k, v, q_pos, k_pos, dout, lse, delta, window,
                           causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) through ``flash_fwd``, differentiable in q,
    k and v through ``flash_bwd`` (positions, window and ``causal`` get no
    gradient).  Both are looked up in this module when called, so a caller
    may stand another function in for either."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window: int, causal: bool):
        out, lse = flash_fwd(q, k, v, q_pos, k_pos, window, causal)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, q_pos, k_pos, out, lse,
                               dout.contiguous(), ctx.window, ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                    k_pos: Tensor, window: int, *, causal: bool = True,
                    block_q: int = 512, block_k: int = 512,
                    interpret: bool = False) -> Tensor:
    """The reference's signature and shapes: q (B, T, H, d), k/v
    (B, S, H, d) (or (B, S, KV, d), H a multiple of KV), i32 positions,
    window an int (≤ 0: full) → (B, T, H, d), differentiable in q, k and
    v (``FlashAttention``).  ``block_q``, ``block_k`` and ``interpret`` are
    the reference's TPU tiling and interpret-mode switches: accepted and
    ignored (the kernels tile 64 × 64 and mask their ragged edges; the CPU
    takes the plain versions)."""
    del block_q, block_k, interpret
    return FlashAttention.apply(q, k, v, q_pos, k_pos, int(window), causal)
