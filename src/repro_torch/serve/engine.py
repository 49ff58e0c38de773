"""Batched serving engine (continuous-batching-lite) — the port of
``repro.serve.engine``.

A fixed pool of B decode slots shares one stacked KV cache.  Requests are
admitted into free slots (their prompt prefilled into a single-row cache,
then scattered into the slot's region of the stacked cache); every tick
advances all active slots by one token (one ``decode_step``); finished
slots (EOS or max_tokens) are freed for the queue.  Prefill and decode use
the plain cached attention, as in the reference: no flash kernel runs here.

Prompts are end-padded to a power-of-two bucket and prefilled masked
(``transformer.prefill`` with ``lengths``), as the reference does.  The
reference keeps an LRU of *compiled* prefill functions per bucket; eager
PyTorch compiles nothing, so that cache (and its ``prefill_cache_cap``
and ``prefill_traces``) is not ported.  Only the dense family is ported,
so every config here is maskable (the reference's exact-length fallback
for recurrent families has nothing to serve yet).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.types import map_tree, resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    max_tokens: int = 16
    eos_id: int = -1
    out_tokens: Optional[List[int]] = None
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Any, n_slots: int,
                 max_len: int, device=None):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.cache = transformer.init_cache(cfg, n_slots, max_len,
                                            device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.last_token = np.zeros((n_slots, 1), np.int32)
        # the two model calls, as attributes (the reference keeps its
        # jitted decode here) so a caller may wrap them, e.g. to time them
        self.prefill = lambda p, tokens, lengths, cache: transformer.prefill(
            p, cfg, {"tokens": tokens, "lengths": lengths}, cache)
        self.decode = lambda p, token, cache: transformer.decode_step(
            p, cfg, token, cache)

    def submit(self, req: Request) -> None:
        req.out_tokens = []
        self.queue.append(req)

    def _prefill_bucket(self, s: int) -> int:
        """Padded prompt length for a true length ``s``: the next power of
        two, never past the cache ring (a bucket wider than max_len would
        wrap and stamp pos = −1 over real early keys)."""
        b = max(1, 1 << (int(s) - 1).bit_length())
        return min(b, self.max_len) if s <= self.max_len else s

    @torch.no_grad()
    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            # per-slot prefill on a fresh single-row cache, then scatter
            # into the shared stacked cache at this slot
            row_cache = transformer.init_cache(self.cfg, 1, self.max_len,
                                               device=self.device)
            s = len(req.prompt)
            padded = self._prefill_bucket(s)
            toks = np.zeros((1, padded), np.int32)
            toks[0, :s] = req.prompt
            logits, row_cache = self.prefill(
                self.params, torch.from_numpy(toks).to(self.device),
                torch.tensor([s], dtype=torch.int32, device=self.device),
                row_cache)
            self.cache = map_tree(
                lambda full, row: _scatter_slot(full, row, slot),
                self.cache, row_cache)
            tok = int(torch.argmax(logits[0]))
            req.out_tokens.append(tok)
            self.last_token[slot, 0] = tok
            self.slot_req[slot] = req

    @torch.no_grad()
    def tick(self) -> int:
        """One engine step: admit + decode all active slots.  Returns the
        number of active slots stepped."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        logits, self.cache = self.decode(
            self.params, torch.from_numpy(self.last_token).to(self.device),
            self.cache)
        next_tok = torch.argmax(logits, dim=-1).cpu().numpy()
        for slot in active:
            req = self.slot_req[slot]
            tok = int(next_tok[slot])
            req.out_tokens.append(tok)
            self.last_token[slot, 0] = tok
            if tok == req.eos_id or len(req.out_tokens) >= req.max_tokens:
                req.done = True
                self.slot_req[slot] = None
        return len(active)

    def run(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.tick()


def _scatter_slot(full: torch.Tensor, row: torch.Tensor, slot: int
                  ) -> torch.Tensor:
    """Write a single-row cache leaf into batch position ``slot``, in
    place, and return it.

    Handles leading-layer-stacked tensors ((L, B, ...) vs (L, 1, ...)) and
    plain batched ones ((B, ...) vs (1, ...), such as idx)."""
    if full.ndim == row.ndim and row.shape[0] == 1 \
            and full.shape[0] != 1 and full.shape[1:] == row.shape[1:]:
        full[slot] = row[0]
        return full
    if full.ndim >= 2 and row.shape[0] == full.shape[0] \
            and row.shape[1] == 1:
        full[:, slot] = row[:, 0]
        return full
    raise ValueError(f"unexpected cache leaf shapes {tuple(full.shape)} vs "
                     f"{tuple(row.shape)}")
