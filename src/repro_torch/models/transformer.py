"""Model assembly, dense family — the port of ``repro.models.transformer``.

Parameter trees are built from ``param_defs`` (one source of truth for
shapes and init); layer weights are stacked on a leading L axis and run by
a Python loop over the layers (the reference's ``lax.scan``).  Per-layer
SWA windows come from ``layer_windows``.

Entry points (all on tensors over an explicit parameter dict):
  ``forward_train`` / ``loss_fn`` — full-sequence logits / LM loss; the
                     attention follows ``layers.ATTN_IMPL`` ("flash": the
                     CUDA flash-attention kernel)
  ``prefill``      — run the prompt, fill the decode cache
  ``decode_step``  — one token with the (full or ring-buffer) cache
Both cached paths use the plain chunked ``layers.attention``, as the
reference's do.  Only the dense family is ported: moe, mla, hybrid, ssm,
encdec and vlm raise ``NotImplementedError`` (ROADMAP.md queue 1,
"The other LM families").
Under ``torch.no_grad()`` (scoring, prefill, decode) nothing is kept for
gradients.  With gradients on, each layer is recomputed in the backward
(the reference's remat, ``nothing_saveable``), and "flash" differentiates
through the CUDA backward kernels (``train.trainer._grads``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import map_tree, resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts or cfg.is_encdec \
            or cfg.rope_style == "mrope":
        raise NotImplementedError(
            f"{cfg.name!r} (family {cfg.family!r}) is not ported to "
            "repro_torch yet: only the dense family is (ROADMAP.md queue 1, "
            "'The other LM families')")


# =========================================================================
# Parameter definitions
# =========================================================================

def _mk(shape, scale=0.02, kind="normal"):
    return {"shape": tuple(shape), "scale": scale, "kind": kind}


def _attn_defs(cfg: ModelConfig, L: int) -> Dict[str, dict]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": _mk((L, d, h, hd)),
        "wk": _mk((L, d, kv, hd)),
        "wv": _mk((L, d, kv, hd)),
        "wo": _mk((L, h, hd, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = _mk((L, hd), kind="zeros")
        defs["k_norm"] = _mk((L, hd), kind="zeros")
    return defs


def _mlp_defs(cfg: ModelConfig, L: int) -> Dict[str, dict]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": _mk((L, d, f)),
        "w_up": _mk((L, d, f)),
        "w_down": _mk((L, f, d)),
    }


def _block_defs(cfg: ModelConfig, L: int) -> Dict[str, Any]:
    """Per-layer defs of the dense decoder stack."""
    _check_family(cfg)
    return {
        "ln1": _mk((L, cfg.d_model), kind="zeros"),
        "ln2": _mk((L, cfg.d_model), kind="zeros"),
        "attn": _attn_defs(cfg, L),
        "mlp": _mlp_defs(cfg, L),
    }


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "embed": _mk((v, d), scale=1.0),
        "final_norm": _mk((d,), kind="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = _mk((d, v))
    defs["blocks"] = _block_defs(cfg, cfg.n_layers)
    return defs


def _is_leaf(x) -> bool:
    return isinstance(x, dict) and "shape" in x and "kind" in x


def _init_leaf(gen: torch.Generator, leaf: dict, dtype: torch.dtype,
               device: torch.device) -> Tensor:
    shape, kind, scale = leaf["shape"], leaf["kind"], leaf["scale"]
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = min(scale, 1.0 / np.sqrt(max(fan_in, 1)))
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Parameters on ``device`` (CUDA unless named) in cfg's dtype: the
    reference's scheme (zeros for norms, N(0, min(scale, 1/√fan_in)) for
    weights) drawn from one ``torch.Generator`` seeded with ``seed`` on
    that device — so the numbers are not the reference's (tests carry
    params across with ``interop.lm_params_from_numpy``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return map_tree(lambda leaf: _init_leaf(gen, leaf, cfg.param_dtype,
                                            device),
                    param_defs(cfg), is_leaf=_is_leaf)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(np.prod(params.shape))


# =========================================================================
# Per-layer window pattern
# =========================================================================

def layer_windows(cfg: ModelConfig, override_window: int = 0) -> np.ndarray:
    """(L,) int32: 0 = full attention, w > 0 = sliding window of w."""
    L = cfg.n_layers
    if override_window:
        return np.full((L,), override_window, np.int32)
    if cfg.attn_kind == "swa" and cfg.window:
        w = np.full((L,), cfg.window, np.int32)
        for g in cfg.global_layers:
            w[g] = 0
        return w
    return np.zeros((L,), np.int32)


# =========================================================================
# Block forwards
# =========================================================================

def _dense_attn_block(p, x, positions, cfg: ModelConfig, window,
                      kv_cache=None, cache_idx=None):
    """Self-attention with an optional cache.  Returns the block's output.

    kv_cache: None (full sequence) or a dict with k/v (B, Sc, KV, hd) and
    pos (B, Sc) (views into the layer-stacked cache); the new k/v/pos are
    written in place at slots (idx + i) mod Sc — the reference donates the
    cache and gets a new one; here the write costs no copy of it.
    """
    qkn = (p.get("q_norm"), p.get("k_norm")) if cfg.qk_norm else None
    q, k, v = layers.gqa_project(x, p["wq"], p["wk"], p["wv"],
                                 qk_norm_scales=qkn)
    if cfg.rope_style == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        attn = layers.attention_trainpath(q, k, v, positions, positions,
                                          window=window)
    else:
        sc = kv_cache["k"].shape[1]
        b, t = x.shape[0], x.shape[1]
        slot = torch.remainder(
            cache_idx[:, None].long()
            + torch.arange(t, device=x.device)[None], sc)
        rows = torch.arange(b, device=x.device)[:, None]
        k_all, v_all, pos_all = kv_cache["k"], kv_cache["v"], kv_cache["pos"]
        k_all[rows, slot] = k.to(k_all.dtype)
        v_all[rows, slot] = v.to(v_all.dtype)
        pos_all[rows, slot] = positions.to(pos_all.dtype)
        valid = pos_all >= 0
        attn = layers.attention(q, k_all.to(q.dtype), v_all.to(q.dtype),
                                positions, pos_all, causal=True,
                                window=window, k_valid=valid)
    return layers.attn_out(attn, p["wo"])


def _ffn(pblk, x, cfg: ModelConfig):
    m = pblk["mlp"]
    return layers.gated_mlp(x, m["w_gate"], m["w_up"], m["w_down"], cfg.act)


def _decoder_block(pblk, x, positions, cfg: ModelConfig, window,
                   kv_cache=None, cache_idx=None):
    """One dense transformer block (writes ``kv_cache`` in place)."""
    h = layers.rms_norm(x, pblk["ln1"])
    x = x + _dense_attn_block(pblk["attn"], h, positions, cfg, window,
                              kv_cache, cache_idx)
    h2 = layers.rms_norm(x, pblk["ln2"])
    return x + _ffn(pblk, h2, cfg)


def _scan_blocks(params_blocks, x, positions, cfg: ModelConfig, windows,
                 caches=None, cache_idx=None, remat: bool = True):
    """The stacked decoder blocks, layer by layer (the reference's
    ``lax.scan``).  ``caches`` (stacked over L) are written in place.

    Each layer takes its weights with one ``torch.unbind`` per stacked
    leaf: under gradients its backward stacks the L layer gradients once,
    where indexing ``t[i]`` would add L full-size (L, ...) buffers.  With
    gradients on and no cache, each layer runs under
    ``torch.utils.checkpoint`` when ``remat`` (the reference checkpoints
    every layer with ``nothing_saveable``): only the layer inputs are
    kept, and the backward runs each layer's forward again (the flash
    kernels are deterministic, so the second run equals the first)."""
    per_layer = map_tree(torch.unbind, params_blocks)
    remat = remat and caches is None and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        kv_c = None if caches is None else map_tree(lambda t: t[i], caches)
        args = (map_tree(lambda t: t[i], per_layer), x, positions, cfg,
                int(windows[i]), kv_c, cache_idx)
        x = checkpoint(_decoder_block, *args, use_reentrant=False) \
            if remat else _decoder_block(*args)
    return x


# =========================================================================
# Caches
# =========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """The dense decode cache: k/v (L, B, max_len, KV, hd), pos (L, B,
    max_len) at −1 (empty), idx (B,).  max_len may be below the context
    length (ring-buffer / sliding-window serving)."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = dtype or cfg.param_dtype
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {
        "idx": torch.zeros((batch,), dtype=torch.int32, device=device),
        "kv": {
            "k": torch.zeros((L, batch, max_len, kv, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((L, batch, max_len, kv, hd), dtype=dt,
                             device=device),
            "pos": torch.full((L, batch, max_len), -1, dtype=torch.int32,
                              device=device),
        },
    }


# =========================================================================
# Entry points
# =========================================================================

def _embed_inputs(params, cfg: ModelConfig, tokens):
    return layers.embed(tokens, params["embed"], scale=cfg.embed_scale)


def _logits(params, cfg: ModelConfig, x):
    x = layers.rms_norm(x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return layers.unembed(x, table, cfg.tie_embeddings)


def _arange_positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, dtype=torch.int32,
                        device=device)[None].expand(b, s)


def forward_train(params, cfg: ModelConfig, batch: Dict[str, Tensor]):
    """Full-sequence causal logits (B, S, V) float32."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _arange_positions(B, S, tokens.device)
    x = _embed_inputs(params, cfg, tokens)
    x = _scan_blocks(params["blocks"], x, positions, cfg,
                     layer_windows(cfg))
    return _logits(params, cfg, x)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Tensor]):
    logits = forward_train(params, cfg, batch)
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is None:
        return -torch.mean(ll)
    return -torch.sum(ll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def prefill(params, cfg: ModelConfig, batch: Dict[str, Tensor],
            cache: Dict[str, Any]):
    """Run the prompt through the model, filling ``cache``.

    Returns (last-token logits (B, V), cache); the cache's k/v/pos are
    written in place, its idx is a new tensor.  batch["lengths"] ((B,)
    int32, optional) enables masked prefill over end-padded prompts:
    padding columns get position −1 (never valid keys), the write pointer
    advances by each row's true length, and the logits are each row's
    true-last-token logits.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    lengths = batch.get("lengths")
    if lengths is not None and positions is None:
        ar = _arange_positions(B, S, tokens.device)
        positions = torch.where(ar < lengths[:, None], ar, -1)
    if positions is None:
        positions = _arange_positions(B, S, tokens.device)
    x = _embed_inputs(params, cfg, tokens)
    x = _scan_blocks(params["blocks"], x, positions, cfg, layer_windows(cfg),
                     caches=cache["kv"], cache_idx=cache["idx"])
    cache = dict(cache)
    if lengths is None:
        cache["idx"] = cache["idx"] + S
        x_last = x[:, -1:]
    else:
        cache["idx"] = cache["idx"] + lengths.to(cache["idx"].dtype)
        idx_last = torch.clamp(lengths.long() - 1, 0, S - 1)
        x_last = x[torch.arange(B, device=x.device), idx_last][:, None, :]
    logits = _logits(params, cfg, x_last)
    return logits[:, 0], cache


def decode_step(params, cfg: ModelConfig, token: Tensor,
                cache: Dict[str, Any]):
    """One decode step.  token: (B, 1) → (logits (B, V), cache), the
    cache written in place as in ``prefill``.

    A sliding-window config whose cache ring is no longer than its window
    runs every layer at that window (the reference's ring-buffer
    override)."""
    _check_family(cfg)
    pos = cache["idx"][:, None].to(torch.int32)
    x = _embed_inputs(params, cfg, token)
    ring = cfg.attn_kind == "swa" and cache["kv"]["k"].shape[2] <= cfg.window
    windows = layer_windows(cfg, override_window=cfg.window if ring else 0)
    x = _scan_blocks(params["blocks"], x, pos, cfg, windows,
                     caches=cache["kv"], cache_idx=cache["idx"])
    cache = dict(cache, idx=cache["idx"] + 1)
    logits = _logits(params, cfg, x)
    return logits[:, 0], cache
