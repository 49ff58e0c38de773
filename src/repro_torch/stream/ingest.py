"""Micro-batch ingestion: chunking, double-buffered H2D, path dispatch.

Counterpart of ``repro.stream.ingest``.  The learner is strictly sequential
in the data, so the only freedoms are when host→device copies happen and
which body consumes a chunk:

  "scan" — ``core.figmn.fit`` over the chunk (creation and pruning inline,
           so chunked ingestion equals one ``fit`` over the whole stream);
  "vmem" — the resident CUDA kernels ``kernels.figmn_stream``: the whole
           (K, D, D) working set stays in shared memory for the chunk, in
           one block when it fits one, else spread over a cooperative grid
           of blocks (``figmn_stream.grid_plan``).  Creation events are
           no-ops inside them; with a lifecycle the runtime buffers the
           gate failures for the spawn pass.  (The name is the reference's;
           on the card the resident memory is shared memory.)
  "sparse" — the top-C shortlist body ``core.shortlist.fit_sparse``: per
           point an O(K·D) bound pass selects C components and the exact
           O(D²) work runs on those C rows (the ``gathered_matvec`` and
           ``scatter_apply`` kernels with ``backend="pallas"``).  Creation
           and pruning inline, no host sync per point; bit-identical to
           "scan" (plain backend) when C ≥ active K.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import figmn, shortlist
from repro_torch.core.types import (FIGMNConfig, FIGMNState, Tensor,
                                    gate_threshold, resolve_device)
from repro_torch.kernels import figmn_stream

PATHS = ("auto", "scan", "vmem", "sparse")

#: The reference's budget for the resident kernel (``K·D²·4`` bytes of Λ),
#: what ``repro.stream.ingest`` assumes a TPU core's VMEM holds.
DEFAULT_VMEM_BUDGET = 12 * 2 ** 20


def _resident_fits(cfg: FIGMNConfig, device: torch.device,
                   smem_limit: Optional[int], max_blocks: Optional[int]
                   ) -> Tuple[bool, str]:
    """Whether the card holds the pool resident (one block or a grid),
    and why not."""
    try:
        figmn_stream.resident_plan(cfg.kmax, cfg.dim, device, smem_limit,
                                   max_blocks)
    except ValueError as e:
        return False, str(e)
    return True, ""


def select_path(cfg: FIGMNConfig, *,
                vmem_budget: Optional[int] = DEFAULT_VMEM_BUDGET,
                requested: str = "auto", device=None,
                smem_limit: Optional[int] = None,
                max_blocks: Optional[int] = None) -> str:
    """Choose the per-chunk path ("scan" | "vmem" | "sparse").

    "auto" picks the shortlist body whenever the config enables one
    (cfg.shortlist_c > 0), as the reference does; a forced "sparse" needs
    cfg.shortlist_c > 0 and raises otherwise.  Else, on a CUDA device,
    "auto" picks the resident kernels iff the update mode is the PSD-safe
    "exact" one (their only mode), the reference's working set
    ``kmax·D²·4`` bytes is within ``vmem_budget`` (None: the 12 MiB
    ``DEFAULT_VMEM_BUDGET``), and the card holds the pool resident: in one
    block's shared memory or in a grid of co-resident blocks
    (``figmn_stream.resident_plan``; ``smem_limit`` and ``max_blocks``
    override the per-block shared memory and the co-resident block count
    queried from the device).  Elsewhere "scan".  A forced "vmem" that the
    card cannot hold raises instead of falling back.  On the CPU "auto" is
    "scan" and a forced "vmem" runs the plain resident loop.
    """
    if vmem_budget is None:
        vmem_budget = DEFAULT_VMEM_BUDGET
    if requested == "sparse" or (requested == "auto"
                                 and cfg.shortlist_c > 0):
        if cfg.shortlist_c <= 0:
            raise ValueError("path 'sparse' requires cfg.shortlist_c > 0")
        return "sparse"
    if requested not in PATHS:
        raise ValueError(f"unknown path {requested!r}")
    device = resolve_device(device)
    if requested == "scan":
        return "scan"
    if requested == "vmem":
        if cfg.update_mode != "exact":
            raise ValueError("path 'vmem' runs the exact update mode only")
        if device.type == "cuda":
            fits, why = _resident_fits(cfg, device, smem_limit, max_blocks)
            if not fits:
                raise ValueError(f"path 'vmem' cannot hold the pool on "
                                 f"{device}: {why}")
        return "vmem"
    if (device.type == "cuda" and cfg.update_mode == "exact"
            and cfg.kmax * cfg.dim * cfg.dim * 4 <= vmem_budget
            and _resident_fits(cfg, device, smem_limit, max_blocks)[0]):
        return "vmem"
    return "scan"


NONFINITE_POLICIES = ("drop", "reject", "raise")


class NonFiniteChunkError(ValueError):
    """A chunk carried NaN/Inf rows under ``on_nonfinite="raise"``."""


def finite_guard(xc_host: np.ndarray, policy: str = "drop"
                 ) -> Tuple[np.ndarray, int]:
    """Quarantine non-finite rows BEFORE they can touch Λ.

      "drop"   keep only the finite rows (the state then equals that of a
               stream that never contained the poisoned rows),
      "reject" quarantine the WHOLE chunk,
      "raise"  raise NonFiniteChunkError.

    Returns ``(kept_rows, n_quarantined)``.  The all-finite fast path
    returns the input array itself, so the runtime keeps using the device
    copy already in flight.
    """
    if policy not in NONFINITE_POLICIES:
        raise ValueError(
            f"on_nonfinite must be one of {NONFINITE_POLICIES}")
    finite = np.isfinite(xc_host).all(axis=1)
    if finite.all():
        return xc_host, 0
    if policy == "raise":
        bad = int((~finite).sum())
        raise NonFiniteChunkError(
            f"{bad}/{xc_host.shape[0]} non-finite rows in chunk "
            f"(on_nonfinite='raise')")
    if policy == "reject":
        return xc_host[:0], int(xc_host.shape[0])
    return xc_host[finite], int((~finite).sum())


class DoubleBufferedLoader:
    """Chunked host→device feed with one chunk of copy lookahead.

    On a CUDA device each chunk is staged in one of two pinned host
    buffers and copied with ``non_blocking=True`` on a side stream, issued
    one chunk ahead of the consumer; the consumer's stream waits on the
    copy's event before it touches the chunk.  A staging buffer is refilled
    only after the copy that last read it has completed.
    """

    def __init__(self, xs, chunk: int, device, dtype=torch.float32):
        self._np = np.asarray(xs)
        if self._np.ndim != 2:
            raise ValueError(f"expected (N, D) stream, got {self._np.shape}")
        self.chunk = int(chunk)
        self.device = resolve_device(device)
        self.dtype = dtype

    def __len__(self) -> int:
        return -(-self._np.shape[0] // self.chunk) if self._np.size else 0

    def __iter__(self) -> Iterator[Tuple[Tensor, np.ndarray]]:
        """Yields (device_chunk, host_chunk) pairs in stream order."""
        n, d = self._np.shape
        bounds = [(i, min(i + self.chunk, n))
                  for i in range(0, n, self.chunk)]
        if not bounds:
            return
        if self.device.type != "cuda":
            for a, b in bounds:
                yield (torch.tensor(self._np[a:b], dtype=self.dtype,
                                    device=self.device), self._np[a:b])
            return
        rows = min(self.chunk, n)
        staging = [torch.empty((rows, d), dtype=self.dtype, pin_memory=True)
                   for _ in range(2)]
        done = [None, None]
        copy_stream = torch.cuda.Stream(self.device)

        def put(j: int):
            a, b = bounds[j]
            slot = j % 2
            if done[slot] is not None:
                done[slot].synchronize()
            host = staging[slot][:b - a]
            host.copy_(torch.from_numpy(np.ascontiguousarray(self._np[a:b])))
            with torch.cuda.stream(copy_stream):
                dev = torch.empty((b - a, d), dtype=self.dtype,
                                  device=self.device)
                dev.copy_(host, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy_stream)
            done[slot] = ev
            return dev, ev

        nxt = put(0)
        for j, (a, b) in enumerate(bounds):
            dev, ev = nxt
            if j + 1 < len(bounds):
                nxt = put(j + 1)                 # overlap with the consumer
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ev)
            dev.record_stream(consumer)
            yield dev, self._np[a:b]


def fit_chunk_scan(cfg: FIGMNConfig, state: FIGMNState, xc: Tensor,
                   do_prune: bool) -> FIGMNState:
    """Reference path: ``figmn.fit`` over the chunk (consumes the state)."""
    return figmn.fit(cfg, state, xc, do_prune=do_prune)


def fit_chunk_sparse(cfg: FIGMNConfig, state: FIGMNState, xc: Tensor,
                     do_prune: bool) -> FIGMNState:
    """Shortlist path: ``shortlist.fit_sparse`` over the chunk (consumes
    the state; bit-identical to "scan" with the plain backend when
    cfg.shortlist_c ≥ active K)."""
    return shortlist.fit_sparse(cfg, state, xc, do_prune=do_prune)


def fit_chunk_vmem(cfg: FIGMNConfig, state: FIGMNState, xc: Tensor
                   ) -> Tuple[FIGMNState, Tensor]:
    """Resident path: the whole chunk in one kernel launch.

    Gate-failing points leave the state untouched (the kernel cannot
    create).  Returns (state', n_accepted) with the accept counter left ON
    THE DEVICE — pulling it here would sync the host on every chunk.
    """
    n = int(xc.shape[0])
    f32 = torch.float32
    mu, lam, logdet, sp, nacc = figmn_stream.figmn_stream(
        xc.to(f32).contiguous(), state.mu.to(f32).contiguous(),
        state.lam.to(f32).contiguous(), state.logdet.to(f32).contiguous(),
        state.sp.to(f32).contiguous(), state.active.to(torch.int32),
        gate_threshold(cfg), cfg.dim)
    dt = cfg.dtype
    new = FIGMNState(
        mu=mu.to(dt), lam=lam.to(dt), logdet=logdet.to(dt), sp=sp.to(dt),
        # eq. 4: every active component ages once per point
        v=state.v + n * state.active.to(dt),
        active=state.active, n_created=state.n_created)
    return new, nacc[0]


def chunk_stats(cfg: FIGMNConfig, state: FIGMNState, xc: Tensor,
                thresh: float) -> Tuple[Tensor, Tensor]:
    """(fails (B,) bool, mean mixture log-likelihood ()) against the frozen
    parameters, from ONE batched pass over Λ (``figmn.log_joint_batch``)."""
    d2, logjoint = figmn.log_joint_batch(cfg, state, xc)
    fails = ~torch.any(state.active[None, :] & (d2 < thresh), dim=1)
    return fails, torch.logsumexp(logjoint, dim=1).mean()


score_batch = figmn.score_batch
