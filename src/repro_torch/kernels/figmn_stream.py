"""CUDA kernels: the resident streaming FIGMN fit, with its plain version.

Replaces ``repro/kernels/figmn_stream.py::figmn_stream_pallas``.  On the TPU
the whole (K, D, D) working set sat in VMEM for a chunk, up to the
reference's 12 MiB budget; on Hopper it sits in shared memory:

  one block  (``csrc/figmn_stream.cu``): a pool that fits one block's
             opt-in shared memory (227 KB on H100, queried from the device);
  a grid     (``csrc/figmn_stream_grid.cu``): a larger pool, its (K·D, D)
             stack of Λ rows cut into G contiguous ranges, one per
             co-resident block, with one grid barrier per point
             (``grid_plan`` sizes it).

Either way device memory sees only the x_t rows and, on the grid, the
per-point y and d² exchange.  One launch runs a whole chunk: per point the
matvec, d², chi² gate, the kernel's own masked posterior, the sp/μ update,
the exact fused rank-one update and logdet, and an accept counter.
Gate-failing points are no-ops; creation is the caller's business
(``stream.ingest.fit_chunk_vmem``).

Bound: with the state on chip the work is ≈ 6·K·D² flops per point; one
block uses one SM, and the grid pays one barrier per point, so both run far
below the card's rate (PERF.md §6, rows 3 and 3b).

Plain version: ``ref.figmn_stream_ref``, taken only for a CPU tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _LOG_2PI, figmn_stream_ref

Tensor = torch.Tensor

figmn_stream_plain = figmn_stream_ref

# Rows of the Λ stack the grid plan aims to give each block: four per warp
# of the kernel's 16, so the matvec keeps every warp busy while the pool is
# spread over as many SMs as it can use.
MIN_ROWS = 64
_GRID_WARPS = 16


def smem_bytes(k: int, d: int) -> int:
    """Shared memory the one-block kernel holds for a (K, D) pool: Λ
    (K·D²), μ, diff and y (K·D each), seven (K,) vectors and x (D), all
    float32 — the layout of ``csrc/figmn_stream.cu``
    (``figmn_stream_smem_bytes``)."""
    return 4 * (k * d * d + 3 * k * d + 7 * k + d)


def _span(rows: int, d: int) -> int:
    """The most components that ``rows`` consecutive rows of the (K·D, D)
    stack can touch, wherever they start."""
    return (rows + d - 2) // d + 1


def grid_smem_bytes(rows: int, nc: int, d: int) -> int:
    """Shared memory of one grid block holding ``rows`` Λ rows that touch at
    most ``nc`` components: the rows, μ, diff and the full y of those
    components, y of its rows, x, three coefficients per component and the
    reduction scratch — the layout of ``csrc/figmn_stream_grid.cu``
    (``figmn_stream_grid_smem_bytes``)."""
    return 4 * (rows * d + 3 * nc * d + rows + d + 3 * nc + _GRID_WARPS)


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """How the grid kernel spreads a (K, D) pool: ``rows`` Λ rows per block
    (the last block takes the rest), ``blocks`` blocks (G), at most ``nc``
    components touched by one block, ``smem_bytes`` per block."""
    rows: int
    blocks: int
    nc: int
    smem_bytes: int


def grid_plan(k: int, d: int, smem_limit: int, max_blocks: int,
              blocks: Optional[int] = None) -> GridPlan:
    """Plan the grid kernel for a (K, D) pool on a card whose blocks may use
    ``smem_limit`` bytes of shared memory and of which ``max_blocks`` can be
    co-resident.

    Without ``blocks`` the plan spreads the K·D rows over
    min(max_blocks, ⌈K·D / MIN_ROWS⌉) blocks, with fewer rows per block
    where one block's share would not fit.  ``blocks`` forces G (the card
    tests use it to run several blocks on a small pool).  Raises ValueError
    when the pool needs more co-resident blocks than ``max_blocks``, when
    one row does not fit a block, or when a forced G does not fit.
    """
    total = k * d
    if total <= 0:
        raise ValueError(f"empty pool K={k}, D={d}")
    want = blocks if blocks is not None \
        else min(max_blocks, -(-total // MIN_ROWS))
    want = max(1, min(want, total))
    rows = -(-total // want)
    lo, hi = 0, rows                  # largest r ≤ rows whose block fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if grid_smem_bytes(mid, _span(mid, d), d) <= smem_limit:
            lo = mid
        else:
            hi = mid - 1
    if lo == 0:
        raise ValueError(f"one Λ row of D = {d} does not fit the "
                         f"{smem_limit} bytes of shared memory of a block")
    if blocks is not None and lo < rows:
        raise ValueError(f"{blocks} blocks of {rows} rows (K={k}, D={d}) do "
                         f"not fit {smem_limit} bytes of shared memory each")
    rows = lo
    g = -(-total // rows)
    if g > max_blocks:
        raise ValueError(
            f"resident pool K={k}, D={d} needs {g} co-resident blocks of "
            f"{rows} rows; the card holds {max_blocks}")
    nc = _span(rows, d)
    return GridPlan(rows=rows, blocks=g, nc=nc,
                    smem_bytes=grid_smem_bytes(rows, nc, d))


def plan_blocks(plan: GridPlan, k: int, d: int) -> List[Tuple[int, int]]:
    """Each block's range of Λ rows as (first row, row count), the split
    the kernel makes from ``plan``."""
    total = k * d
    return [(b * plan.rows, min(plan.rows, total - b * plan.rows))
            for b in range(plan.blocks)]


_CAPACITY: Dict[Tuple[int, int], int] = {}


def grid_capacity(device: torch.device, smem_limit: int) -> int:
    """Blocks of the grid kernel that ``device`` holds co-resident at
    ``smem_limit`` bytes each: 0 on a card without cooperative launch.
    Queried once per (device, bytes)."""
    key = (_build.device_index(device), int(smem_limit))
    if key not in _CAPACITY:
        per_sm = 0
        if _build.coop_launch(device):
            per_sm = _build.lib().figmn_stream_grid_blocks_per_sm(*key)
            if per_sm < 0:
                _build.check(-per_sm, "figmn_stream_grid occupancy query")
        _CAPACITY[key] = per_sm * _build.sm_count(device)
    return _CAPACITY[key]


def resident_plan(k: int, d: int, device: torch.device,
                  smem_limit: Optional[int] = None,
                  max_blocks: Optional[int] = None) -> Optional[GridPlan]:
    """None when the (K, D) pool fits the one-block kernel, else the grid
    plan (raises ValueError when even the grid cannot hold it).  The
    limits are queried from ``device`` unless given."""
    if smem_limit is None:
        smem_limit = _build.smem_optin(device)
    if smem_bytes(k, d) <= smem_limit:
        return None
    if max_blocks is None:
        max_blocks = grid_capacity(device, smem_limit)
    return grid_plan(k, d, smem_limit, max_blocks)


def _launch_grid(xs, mu, lam, logdet, sp, active, thresh, dim, outs, nacc,
                 plan: GridPlan) -> None:
    n, d = xs.shape
    k = mu.shape[0]
    dev = xs.device
    total = k * d
    if (plan.rows * plan.blocks < total
            or (plan.blocks - 1) * plan.rows >= total
            or plan.nc < _span(plan.rows, d)
            or plan.smem_bytes != grid_smem_bytes(plan.rows, plan.nc, d)):
        raise ValueError(f"{plan} does not cover a K={k}, D={d} pool")
    if not _build.coop_launch(dev):
        raise RuntimeError(f"{dev} does not support cooperative launch; the "
                           "grid kernel needs it")
    limit = _build.smem_optin(dev)
    if plan.smem_bytes > limit:
        raise ValueError(f"{plan.smem_bytes} bytes per block exceed the "
                         f"{limit} a block may use on {dev}")
    f32 = torch.float32
    ybuf = torch.empty((2, total), dtype=f32, device=dev)
    d2part = torch.empty((2, plan.blocks, plan.nc), dtype=f32, device=dev)
    kvec = torch.empty((plan.blocks, 4, k), dtype=f32, device=dev)
    bar = torch.zeros((2,), dtype=torch.int32, device=dev)
    err = _build.lib().figmn_stream_grid(
        xs.data_ptr(), n, mu.data_ptr(), lam.data_ptr(), logdet.data_ptr(),
        sp.data_ptr(), active.data_ptr(), float(thresh), dim * _LOG_2PI,
        float(dim), *(o.data_ptr() for o in outs), nacc.data_ptr(),
        ybuf.data_ptr(), d2part.data_ptr(), kvec.data_ptr(), bar.data_ptr(),
        k, d, plan.blocks, plan.rows, plan.nc, _build.stream_ptr(xs))
    _build.check(err, "figmn_stream_grid")
    _build.LAUNCHES["figmn_stream_grid"] += 1


def figmn_stream(xs: Tensor, mu: Tensor, lam: Tensor, logdet: Tensor,
                 sp: Tensor, active: Tensor, thresh: float, dim: int,
                 plan: Optional[GridPlan] = None
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Run the chunk ``xs`` (N, D) with the state held on chip.

    mu (K, D), lam (K, D, D), logdet/sp (K,) float32; active (K,) int32;
    ``thresh`` the float32 gate as a Python float.  Returns new
    (mu, lam, logdet, sp) and the accept count (1,) int32, left on the
    device.  On the card a pool that fits one block runs the one-block
    kernel, a larger one the grid kernel (``plan`` forces the grid with
    that plan); a pool the grid cannot hold, a card without cooperative
    launch or a failed launch raises.  A CPU tensor takes the plain
    version.
    """
    n, d = xs.shape
    k = mu.shape[0]
    dev = xs.device
    _build.check_tensor("xs", xs, (n, d), dev)
    for name, t, shape in (("mu", mu, (k, d)), ("lam", lam, (k, d, d)),
                           ("logdet", logdet, (k,)), ("sp", sp, (k,))):
        _build.check_tensor(name, t, shape, dev)
    _build.check_index("active", active, (k,), dev)
    if not _build.on_cuda(dev):
        return figmn_stream_plain(xs, mu, lam, logdet, sp, active, thresh,
                                  dim)
    if plan is None:
        plan = resident_plan(k, d, dev)
    outs = (torch.empty_like(mu), torch.empty_like(lam),
            torch.empty_like(logdet), torch.empty_like(sp))
    nacc = torch.zeros((1,), dtype=torch.int32, device=dev)
    if not n:
        for o, src in zip(outs, (mu, lam, logdet, sp)):
            o.copy_(src)
    elif plan is not None:
        _launch_grid(xs, mu, lam, logdet, sp, active, thresh, dim, outs,
                     nacc, plan)
    else:
        err = _build.lib().figmn_stream(
            xs.data_ptr(), n, mu.data_ptr(), lam.data_ptr(),
            logdet.data_ptr(), sp.data_ptr(), active.data_ptr(),
            float(thresh), dim * _LOG_2PI, float(dim),
            *(o.data_ptr() for o in outs), nacc.data_ptr(), k, d,
            _build.stream_ptr(xs))
        _build.check(err, "figmn_stream")
        _build.LAUNCHES["figmn_stream"] += 1
    return (*outs, nacc)
