"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
Field for field the reference's ``repro.configs.h2o_danube``.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000,
    act="silu", rope_theta=10000.0,
    attn_kind="swa", window=4096, supports_long_context=True,
)

SMOKE = ModelConfig(
    name="danube-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, act="silu",
    attn_kind="swa", window=8, supports_long_context=True, dtype="float32",
)
