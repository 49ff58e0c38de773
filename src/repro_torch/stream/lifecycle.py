"""Component-pool lifecycle under a fixed K budget, off the per-point path
(counterpart of ``repro.stream.lifecycle``).

§2.3 of the paper gives the spawn and prune rules but no schedule.  As in
the reference, all lifecycle work runs every ``every`` chunks on the host,
so the per-chunk bodies keep a fixed pool shape:

  prune  — the §2.3 age/mass rule (``figmn.prune``);
  spawn  — replay points from the gate-failure buffer through
           ``figmn.learn_one`` (Algorithm 3 creates a component iff the
           point still fails the gate: a point explained by a component
           spawned earlier in the same pass updates it instead);
  merge  — while the pool exceeds ``k_budget``, moment-match the two most
           similar components (``core.merge``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import figmn, merge
from repro_torch.core.types import FIGMNConfig, FIGMNState


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Policy knobs for pool management.

    k_budget:   most live components after a pass (0 ⇒ cfg.kmax).
    every:      chunks between passes.
    spawn_max:  buffered gate-failure points replayed per pass.
    buffer_cap: gate-failure ring-buffer capacity (host memory).
    prune / merge_down: enable the §2.3 prune rule / budget merging.
    """
    k_budget: int = 0
    every: int = 8
    spawn_max: int = 4
    buffer_cap: int = 256
    prune: bool = True
    merge_down: bool = True


@dataclasses.dataclass
class LifecycleReport:
    spawned: int = 0
    pruned: int = 0
    merged: int = 0
    active_k: int = 0


class FailureBuffer:
    """Host-side ring buffer of gate-failing points (spawn candidates)."""

    def __init__(self, cap: int, dim: int):
        self.cap = int(cap)
        self.dim = int(dim)
        self._items: List[np.ndarray] = []

    def __len__(self) -> int:
        return len(self._items)

    def push(self, xs: np.ndarray) -> None:
        if self.cap <= 0:                        # no lifecycle ⇒ no buffer
            return
        for x in np.atleast_2d(np.asarray(xs, np.float32)):
            self._items.append(x)
        if len(self._items) > self.cap:          # drop the oldest
            self._items = self._items[-self.cap:]

    def drain(self, k: Optional[int] = None) -> np.ndarray:
        k = len(self._items) if k is None else min(k, len(self._items))
        out, self._items = self._items[:k], self._items[k:]
        return np.asarray(out, np.float32).reshape(k, self.dim)

    def export_state(self):
        """The buffer as a fixed (cap, dim) array and its fill count, so a
        checkpoint's layout does not depend on the fill level."""
        arr = np.zeros((self.cap, self.dim), np.float32)
        if self._items:
            arr[:len(self._items)] = np.stack(self._items)
        return {"buf": arr,
                "count": np.asarray(len(self._items), np.int64)}

    def load_state(self, payload) -> None:
        n = int(payload["count"])
        arr = np.asarray(payload["buf"], np.float32)
        self._items = [arr[i].copy() for i in range(n)]

    @staticmethod
    def state_template(cap: int, dim: int):
        return {"buf": np.zeros((cap, dim), np.float32),
                "count": np.zeros((), np.int64)}


def run_pass(cfg: FIGMNConfig, lcfg: LifecycleConfig, state: FIGMNState,
             buffer: Optional[FailureBuffer] = None
             ) -> Tuple[FIGMNState, LifecycleReport]:
    """One lifecycle pass: prune → spawn → merge to budget.  The spawn
    replay may write the state's Λ in place (``figmn.learn_one``)."""
    rep = LifecycleReport()
    k_budget = lcfg.k_budget or cfg.kmax

    if lcfg.prune and cfg.spmin > 0:
        before = int(state.n_active)
        state = figmn.prune(cfg, state)
        rep.pruned = before - int(state.n_active)

    if buffer is not None and len(buffer):
        for x in buffer.drain(lcfg.spawn_max):
            state = figmn.learn_one(
                cfg, state, torch.from_numpy(x).to(state.device),
                do_prune=False)
            rep.spawned += 1

    if lcfg.merge_down:
        state, rep.merged = merge.merge_to_budget(cfg, state, k_budget)

    rep.active_k = int(state.n_active)
    return state, rep
