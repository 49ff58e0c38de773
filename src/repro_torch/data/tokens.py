"""Deterministic synthetic LM token pipeline — a copy of the reference's
``repro.data.tokens`` (pure numpy), so both packages yield the same tokens
for the same seed.

Batch i, host h always yields the same tokens (a numpy generator keyed on
(seed, step, host)).  Tokens follow a Zipf marginal over the vocab with
short-range Markov structure, so the LM loss has headroom.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticTokens:
    def __init__(self, cfg: TokenPipelineConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide evenly over n_hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipf marginal + a sparse random bigram kernel
        ranks = np.arange(1, v + 1)
        self._marginal = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._shift = rng.integers(1, v - 1)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        base = rng.choice(v, size=(b, s), p=self._marginal)
        # with p = 0.5 a token is a deterministic function of its
        # predecessor: a learnable signal
        copy_mask = rng.random((b, s)) < 0.5
        shifted = (np.roll(base, 1, axis=1) + self._shift) % v
        tokens = np.where(copy_mask, shifted, base).astype(np.int32)
        targets = np.roll(tokens, -1, axis=1).astype(np.int32)
        return {"tokens": tokens, "targets": targets}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
