"""StreamRuntime — the orchestrator that owns the online loop (counterpart of
``repro.stream.runtime``).

Chunked ingestion (ingest.py), pool lifecycle (lifecycle.py) and per-chunk
telemetry (telemetry.py) over one mixture state on one device.  Invariant
(tested): with the lifecycle off, ``ingest`` over any chunking equals ONE
``core.figmn.fit`` over the concatenated stream (ONE
``core.shortlist.fit_sparse`` on the "sparse" path); with it on, chunked
equals one-shot across ``ingest`` calls.  Reads follow the resolved path: a
shortlisted runtime scores and predicts through the shortlisted reads, a
dense one through the dense reads.

The drift, checkpoint, cost-table, telemetry-anomaly and chunk-retry
options of the reference wait for later slices and are not fields here;
the obs metrics and spans are left out.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import figmn, inference, shortlist
from repro_torch.core.types import (FIGMNConfig, FIGMNState, Tensor,
                                    gate_threshold, resolve_device)
from repro_torch.stream import ingest, lifecycle, telemetry


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Orchestration knobs (the FIGMN hyper-parameters live in FIGMNConfig).

    chunk:        micro-batch size (points per dispatch).
    path:         "auto" | "scan" | "vmem" | "sparse" (see
                  ``ingest.select_path``; "sparse", the top-C shortlist
                  body, needs cfg.shortlist_c > 0 and is what "auto" picks
                  whenever the config enables a shortlist).
    lifecycle:    pool-management policy (``lifecycle.LifecycleConfig``);
                  None disables it, and creation and §2.3 pruning then
                  happen inline in the scan body, matching one-shot
                  ``figmn.fit``.  With a policy, inline pruning waits for
                  the pass, and on the "vmem" path the points that fail
                  the gate against the chunk's starting mixture are
                  buffered for the pass to spawn.
    vmem_budget:  bytes of Λ (``kmax·D²·4``) up to which "auto" picks the
                  resident kernels; None is the reference's 12 MiB
                  ``ingest.DEFAULT_VMEM_BUDGET`` (its fallback where the
                  backend reports no VMEM).  The card must also hold the
                  pool (``ingest.select_path``).
    device:       the torch device the state lives on; None means CUDA
                  (and raises where there is no card).
    on_nonfinite: NaN/Inf row policy of ``ingest.finite_guard``: "drop"
                  (default), "reject" or "raise".
    """
    chunk: int = 256
    path: str = "auto"
    lifecycle: Optional[lifecycle.LifecycleConfig] = None
    vmem_budget: Optional[int] = None
    device: Optional[str] = None
    on_nonfinite: str = "drop"


class StreamRuntime:
    """Owns mixture state + ingestion loop for one unbounded stream."""

    def __init__(self, cfg: FIGMNConfig,
                 rcfg: RuntimeConfig = RuntimeConfig()):
        self.cfg = cfg
        self.rcfg = rcfg
        self.device = resolve_device(rcfg.device)
        self.state: FIGMNState = figmn.init_state(cfg, self.device)
        self.path = ingest.select_path(cfg, requested=rcfg.path,
                                       device=self.device,
                                       vmem_budget=rcfg.vmem_budget)
        self.chunk_idx = 0
        # Bumped on every state mutation: the factor cache's key.
        self.state_epoch = 0
        self.factor_cache = inference.FactorCache()
        self.telemetry = telemetry.Telemetry(capacity=4096)
        # Host copies of (n_active, n_created), refreshed by the one
        # per-chunk sync, so the next chunk's path and creation count need
        # no sync of their own.
        self._n_active = 0
        self._n_created = 0
        self.buffer = lifecycle.FailureBuffer(
            rcfg.lifecycle.buffer_cap if rcfg.lifecycle else 0, cfg.dim)
        self._thresh = gate_threshold(cfg)
        # Deferred device→host pulls: the vmem accept counter and the
        # gate-failure masks stay on the device until a lifecycle boundary
        # (or the end of ``ingest`` for the counter).
        self._accepted_dev = torch.zeros((), dtype=torch.int32,
                                         device=self.device)
        self._pending_fails: List[Tuple[Tensor, np.ndarray]] = []

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------

    def ingest(self, xs) -> Dict[str, object]:
        """Feed an (N, D) stream segment; returns the telemetry summary.
        Callable repeatedly: state and telemetry carry across calls."""
        loader = ingest.DoubleBufferedLoader(xs, self.rcfg.chunk,
                                             self.device, self.cfg.dtype)
        for xc_dev, xc_host in loader:
            xh, n_bad = ingest.finite_guard(xc_host, self.rcfg.on_nonfinite)
            if n_bad:
                self.telemetry.add_quarantined(n_bad)
                if xh.shape[0] == 0:
                    continue
                xc_dev = torch.as_tensor(xh, dtype=self.cfg.dtype,
                                         device=self.device)
            self._ingest_chunk(xc_dev, xh)
        if self.rcfg.lifecycle is not None:
            self._run_lifecycle()
        self._fold_accept_counter()
        return self.telemetry.summary()

    def _ingest_chunk(self, xc: Tensor, xc_host: np.ndarray) -> None:
        cfg, lcfg = self.cfg, self.rcfg.lifecycle
        t0 = time.perf_counter()
        formed = self._n_active > 0
        path = self.path
        if path == "vmem" and not formed:
            path = "scan"            # the kernel cannot create the first slot
        if path == "vmem":
            if lcfg is not None:
                # prequential: the points that fail the gate against the
                # chunk's starting mixture, kept on the device until the
                # next lifecycle pass
                fails, _ = ingest.chunk_stats(cfg, self.state, xc,
                                              self._thresh)
                self._pending_fails.append((fails, xc_host))
            self.state, nacc = ingest.fit_chunk_vmem(cfg, self.state, xc)
            self._accepted_dev += nacc                  # stays on the device
        else:
            # inline creation/§2.3 pruning ⇔ one-shot fit; with a lifecycle
            # pruning waits for the pass
            do_prune = lcfg is None and cfg.spmin > 0
            body = (ingest.fit_chunk_sparse if path == "sparse"
                    else ingest.fit_chunk_scan)
            self.state = body(cfg, self.state, xc, do_prune)
        self.state_epoch += 1
        # The one per-chunk device sync the telemetry needs; it also fences
        # the chunk, so latency_s includes the device compute on every path.
        n_created0 = self._n_created
        self._n_active, self._n_created = torch.stack(
            [self.state.n_active, self.state.n_created]).tolist()
        self.telemetry.record(telemetry.ChunkMetrics(
            idx=self.chunk_idx, n_points=int(xc.shape[0]),
            active_k=self._n_active, created=self._n_created - n_created0,
            path=path, latency_s=time.perf_counter() - t0))
        self.chunk_idx += 1
        if (lcfg is not None and lcfg.every > 0
                and self.chunk_idx % lcfg.every == 0):
            self._run_lifecycle()

    # ------------------------------------------------------------------
    # lifecycle plumbing
    # ------------------------------------------------------------------

    def _drain_pending_fails(self) -> None:
        """Bring the deferred gate-failure masks to the host and push their
        rows into the spawn buffer."""
        for fails_dev, xc_host in self._pending_fails:
            fails = fails_dev.cpu().numpy()
            if fails.any():
                self.buffer.push(xc_host[fails])
        self._pending_fails.clear()

    def _fold_accept_counter(self) -> None:
        """Pull the device-side vmem accept counter into the telemetry: at
        lifecycle boundaries and at the end of ``ingest``, never per
        chunk."""
        n = int(self._accepted_dev)
        if n:
            self.telemetry.add_accepted(n)
            self._accepted_dev.zero_()

    def _run_lifecycle(self) -> None:
        self._drain_pending_fails()
        self._fold_accept_counter()
        self.state, rep = lifecycle.run_pass(self.cfg, self.rcfg.lifecycle,
                                             self.state, self.buffer)
        self.state_epoch += 1
        self.telemetry.add_lifecycle(rep.pruned, rep.merged, rep.spawned)
        self._n_active = rep.active_k
        self._n_created = int(self.state.n_created)

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def score(self, xs) -> Tensor:
        """(N,) mixture log-densities under the current state (read-only).
        On the "sparse" path through ``shortlist.score_batch_sparse`` (a
        (B, K) bound pass and a (B, C) exact pass), else the dense sweep."""
        xs = torch.as_tensor(xs, dtype=self.cfg.dtype, device=self.device)
        if self.path == "sparse":
            return shortlist.score_batch_sparse(self.cfg, self.state, xs)
        return ingest.score_batch(self.cfg, self.state, xs)

    def predict(self, xs, targets, return_var: bool = False):
        """(N, o) eq. 27 conditional means of ``targets`` given the rest
        (read-only; raises on an empty pool), shortlisted on the "sparse"
        path.  The factor stage is cached per state epoch.
        return_var=True also returns the (N, o) conditional variance as a
        (mean, var) pair."""
        return inference.predict_batch_routed(
            self.cfg, self.state, xs, targets,
            c=self.cfg.shortlist_c if self.path == "sparse" else 0,
            return_var=return_var, factor_cache=self.factor_cache,
            epoch=self.state_epoch)
