"""Shared neural-net layers: norms, RoPE, GQA attention (full / SWA),
gated MLPs, embeddings — the port of ``repro.models.layers``.

Pure functions over explicit parameter dicts; layer weights arrive stacked
over the layer axis.  Numerics as in the reference: activations and
params in cfg.dtype, attention logits + softmax and the final logits in
float32.  Not ported yet: ``apply_mrope`` (vlm) and the mesh branch of
``attention_trainpath`` (ROADMAP.md queue 1, "Sharding").
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> Tensor:
    """(head_dim/2,) inverse frequencies, float32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, T, H, hd); positions: (B, T) int32 → same shape, rotated."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs               # (B,T,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; full / sliding-window)
# ---------------------------------------------------------------------------

ATTN_KV_CHUNK = 512


def _attn_one_chunk(q, k, v, q_pos, k_pos, causal, window, k_valid, scale):
    """Un-chunked core: returns (unnormalised ctx, row max m, row sum l)."""
    logits = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale
    dpos = q_pos[:, :, None] - k_pos[:, None, :]                 # (B, T, Sc)
    mask = torch.ones(dpos.shape, dtype=torch.bool, device=q.device)
    if causal:
        mask &= dpos >= 0
    if window > 0:       # a Python int: no host-to-device copy per chunk
        mask &= dpos < window
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    logits = torch.where(mask[:, None, None], logits, -1e30)
    m = logits.amax(dim=-1)                                      # (B,KV,g,T)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    ctx = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return ctx, m, l


def attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
              k_pos: Tensor, causal: bool = True, window: int = 0,
              k_valid: Optional[Tensor] = None,
              kv_chunk: int = ATTN_KV_CHUNK) -> Tensor:
    """Grouped-query attention with online-softmax chunking over keys.

    q: (B, T, H, hd); k, v: (B, S, KV, hd); q_pos: (B, T); k_pos: (B, S).
    window: an int, 0 → full; w > 0 → sliding window of width w.
    k_valid: (B, S) bool — mask for ring-buffer/padded cache slots.
    The key axis is processed in chunks of ``kv_chunk`` with the running
    (max, sum, ctx) rescaling, so the (T × S) logits are never whole;
    decode (t == 1) never chunks.  Returns (B, T, H, hd).
    """
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, t, kvh, g, hd)
    scale = float(1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))
    hd_v = v.shape[-1]
    if s <= kv_chunk or t == 1:
        ctx, m, l = _attn_one_chunk(qg, k, v, q_pos, k_pos, causal,
                                    int(window), k_valid, scale)
        out = ctx.float() \
            / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
        return out.to(q.dtype).reshape(b, t, h, hd_v)

    if s % kv_chunk:
        raise ValueError(f"key length {s} is not a multiple of the "
                         f"{kv_chunk}-key chunk")
    m_run = torch.full((b, kvh, g, t), -torch.inf, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, kvh, g, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, t, kvh, g, hd_v), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, s, kv_chunk):
        sl = slice(c0, c0 + kv_chunk)
        kvc = None if k_valid is None else k_valid[:, sl]
        ctx, m_c, l_c = _attn_one_chunk(qg, k[:, sl], v[:, sl], q_pos,
                                        k_pos[:, sl], causal, int(window),
                                        kvc, scale)
        m_new = torch.maximum(m_run, m_c)
        a_old = torch.exp(m_run - m_new)
        a_new = torch.exp(m_c - m_new)
        l_run = l_run * a_old + l_c * a_new
        acc = acc * a_old.permute(0, 3, 1, 2)[..., None] \
            + ctx.float() * a_new.permute(0, 3, 1, 2)[..., None]
        m_run = m_new
    out = acc / torch.clamp_min(l_run, 1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(q.dtype).reshape(b, t, h, hd_v)


def gqa_project(x: Tensor, wq: Tensor, wk: Tensor, wv: Tensor,
                qk_norm_scales: Optional[Tuple[Tensor, Tensor]] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """x: (B,T,D) → q (B,T,H,hd), k/v (B,T,KV,hd)."""
    q = torch.einsum("btd,dhk->bthk", x, wq)
    k = torch.einsum("btd,dhk->bthk", x, wk)
    v = torch.einsum("btd,dhk->bthk", x, wv)
    if qk_norm_scales is not None:
        q = rms_norm(q, qk_norm_scales[0])
        k = rms_norm(k, qk_norm_scales[1])
    return q, k, v


def attn_out(attn: Tensor, wo: Tensor) -> Tensor:
    return torch.einsum("bthk,hkd->btd", attn, wo)


# Attention for the no-cache (full-sequence) path: "xla" is the plain
# chunked attention above (the reference's name), "flash" the CUDA kernel
# (kernels/flash_attention.py).  The default is the reference's.
ATTN_IMPL = "xla"


def attention_trainpath(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                        k_pos: Tensor, window: int = 0) -> Tensor:
    """Causal self-attention for the no-cache path, honouring ATTN_IMPL.

    With "flash" the kernel reads KV head h // (H / KV) in place (no
    expanded copy of k and v) and the result is differentiable through
    the backward kernels (``FlashAttention``); a CUDA tensor always
    launches them, a CPU tensor takes their plain versions.
    """
    if ATTN_IMPL != "flash":
        return attention(q, k, v, q_pos, k_pos, causal=True, window=window)
    from repro_torch.kernels.flash_attention import flash_attention
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           q_pos.to(torch.int32).contiguous(),
                           k_pos.to(torch.int32).contiguous(), int(window),
                           causal=True)


# ---------------------------------------------------------------------------
# Gated MLPs
# ---------------------------------------------------------------------------

def gated_mlp(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
              act: str = "silu") -> Tensor:
    """SwiGLU (act=silu) / GeGLU (act=gelu): down(act(gate(x)) * up(x))."""
    g = torch.einsum("btd,df->btf", x, w_gate)
    u = torch.einsum("btd,df->btf", x, w_up)
    if act == "gelu":
        h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    else:
        h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("btf,fd->btd", h, w_down)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed(tokens: Tensor, table: Tensor, scale: bool = False) -> Tensor:
    x = table[tokens.long()]
    if scale:
        x = x * torch.sqrt(torch.tensor(float(table.shape[1]))).to(x.dtype)
    return x


def unembed(x: Tensor, table_or_head: Tensor, tied: bool) -> Tensor:
    """→ float32 logits.  tied: table is (V, D); untied: head is (D, V)."""
    if tied:
        return torch.einsum("btd,vd->btv", x.float(), table_or_head.float())
    return torch.einsum("btd,dv->btv", x.float(), table_or_head.float())
