"""Model configuration — the same dataclass as ``repro.models.config``.

Every field and default of the reference is kept, so one field dict drives
both packages; ``param_dtype`` is a torch dtype here.  Only the dense
family runs in this package so far (``models/transformer.py``); the other
families' fields are carried so a config round-trips unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense|moe|mla|hybrid|ssm|encdec|vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 256
    vocab_size: int = 1024
    act: str = "silu"            # silu → SwiGLU, gelu → GeGLU
    rope_theta: float = 10000.0
    rope_style: str = "rope"     # rope | mrope | none
    # attention
    attn_kind: str = "full"      # full | swa (per-layer pattern below)
    window: int = 0              # SWA window size (0 = no SWA anywhere)
    # indices of layers that use FULL attention when attn_kind == "swa"
    global_layers: Tuple[int, ...] = ()
    qk_norm: bool = False
    embed_scale: bool = False    # gemma-style sqrt(d_model) embedding scale
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1           # every k-th layer is MoE (1 = all)
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM / hybrid / xLSTM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0         # xLSTM: every k-th layer is sLSTM (0 = none)
    mlstm_chunk: int = 64
    # encoder-decoder
    n_enc_layers: int = 0
    # M-RoPE sections (t, h, w) — must sum to head_dim // 2
    mrope_sections: Tuple[int, ...] = ()
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # long-context capability flag (set for swa/ssm/hybrid archs)
    supports_long_context: bool = False

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks), the
        reference's formula."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.family == "mla":
            ql, kvl = self.q_lora_rank, self.kv_lora_rank
            nope, rope, vh = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
            attn = d * ql + ql * h * (nope + rope) \
                + d * (kvl + rope) + kvl * h * (nope + vh) + h * vh * d
        mlp = 3 * d * f
        if self.n_experts:
            moe_mlp = self.n_experts * 3 * d * f + d * self.n_experts
            n_moe = self.n_layers // self.moe_every
            mlp = (moe_mlp * n_moe + 3 * d * f * (self.n_layers - n_moe)) \
                / max(self.n_layers, 1)
        block = attn + mlp + 2 * d
        if self.family == "hybrid":
            di, n = self.d_inner, self.ssm_state
            block += 2 * d * di + di * self.ssm_conv + di * (2 * n + 2) + di * d
        if self.family == "ssm":
            di = self.d_inner
            block = 2 * d * di + 3 * di * di // max(self.n_heads, 1) + di * d \
                + 2 * d
        layers = self.n_layers + self.n_enc_layers
        total = block * layers + v * d + (0 if self.tie_embeddings else v * d)
        return int(total)
