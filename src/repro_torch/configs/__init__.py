"""Architecture registry: ``get(arch_id)`` / ``get_smoke(arch_id)``.

The registry keeps the reference's ten arch ids.  Only h2o-danube-1.8b is
ported so far; any other id raises ``NotImplementedError`` (the families
still to port are listed in ROADMAP.md queue 1, "The other LM families")
and never falls back to another model.
"""
from __future__ import annotations

from repro_torch.configs import h2o_danube
from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "llama4-scout-17b-a16e",
    "granite-moe-3b-a800m",
    "yi-6b",
    "gemma-7b",
    "h2o-danube-1.8b",
    "minicpm3-4b",
    "seamless-m4t-large-v2",
    "hymba-1.5b",
    "qwen2-vl-72b",
    "xlstm-1.3b",
)

_PORTED = {"h2o-danube-1.8b": h2o_danube}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in _PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet (ROADMAP.md queue 1, "
            "'The other LM families'); ported: " + ", ".join(_PORTED))
    return _PORTED[arch]


def get(arch: str) -> ModelConfig:
    return _module(arch).FULL


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
