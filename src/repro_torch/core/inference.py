"""Supervised inference — conditional-mean reconstruction (§3 eq. 27), dense
read path.

Counterpart of ``repro.core.inference``.  Given known elements x_i it
reconstructs targets x_t as a posterior-weighted conditional mean, with all
quantities taken from the precision matrix Λ = [[X, Y], [Z, W]]:

  * conditional mean      x̂_t = μ_t − W⁻¹ Z (x_i − μ_i)
  * marginal precision    C_i⁻¹ = X − Y W⁻¹ Z        (Schur complement)
  * marginal determinant  log|C_i| = log|C| + log|W|

Only W (o×o) is ever solved.  The read path is two stages: the factor stage
(once per state and targets; ``FactorCache`` keys it on the state epoch) and
the blocked (block_b, ·) batch stage, which bounds peak memory: at B = 512,
K = 64, i = 784 one (B, K, i) tensor is already 100 MB.

``predict_batch_sparse`` is the shortlisted twin: an O(K·i) diag proxy on
the known-block marginal ranks the slots per point and the exact work runs
on the C shortlisted rows; when C covers the pool it runs the dense block
body itself, so it is bit-identical to ``predict_batch`` by construction.
``predict_batch_routed`` is the one dense/sparse switch the runtime calls.

Empty-mixture contract: every public entry point checks ``n_active`` on the
host and raises instead of returning the silent zero vector an empty pool
would give.  The covariance-form ``predict_ref*`` and the measured routing
(the reference's cost table) wait for a later slice.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import figmn, shortlist
from repro_torch.core.types import FIGMNConfig, FIGMNState, Tensor

_LOG_2PI = 1.8378770664093453


def _split_indices(dim: int, idx_out) -> Tuple[np.ndarray, np.ndarray]:
    idx_out = np.asarray(idx_out, np.int64).reshape(-1)
    idx_in = np.setdiff1d(np.arange(dim, dtype=np.int64), idx_out)
    return idx_in, idx_out


def _as_targets(idx_out) -> Tuple[int, ...]:
    return tuple(int(i) for i in np.asarray(idx_out).reshape(-1))


def require_nonempty(state: FIGMNState) -> None:
    """Host-side guard at the inference API boundary (one device sync)."""
    if int(state.n_active) == 0:
        raise ValueError(
            "cannot run inference on an empty mixture: no active "
            "components (the eq. 27 posterior is undefined and would "
            "silently return zeros) — fit data first")


class _CondFactors(NamedTuple):
    """Per-component eq. 27 factors, computed once per (state, targets)."""
    mu_in: Tensor      # (K, i)
    mu_out: Tensor     # (K, o)
    winv_z: Tensor     # (K, o, i)  W⁻¹Z — the conditional-mean operator
    prec_in: Tensor    # (K, i, i)  C_i⁻¹ = X − Y W⁻¹ Z
    logdet_in: Tensor  # (K,)       log|C_i| = log|C| + log|W|
    wdiag_inv: Tensor  # (K, o)     diag(W⁻¹), per-component variance


def _conditional_factors(state: FIGMNState, idx_in: np.ndarray,
                         idx_out: np.ndarray) -> _CondFactors:
    dev = state.device
    ii = torch.as_tensor(idx_in, device=dev)
    io = torch.as_tensor(idx_out, device=dev)
    lam = state.lam
    X = lam[:, ii[:, None], ii[None, :]]                # (K, i, i)
    Y = lam[:, ii[:, None], io[None, :]]                # (K, i, o)
    W = lam[:, io[:, None], io[None, :]]                # (K, o, o)
    Z = Y.transpose(-1, -2)                             # (K, o, i)
    winv_z = torch.linalg.solve(W, Z)                   # o×o solve only
    prec_in = X - torch.einsum("kio,koj->kij", Y, winv_z)
    _, logdet_w = torch.linalg.slogdet(W)
    o = idx_out.shape[0]
    eye = torch.eye(o, dtype=lam.dtype, device=dev).expand(W.shape)
    winv = torch.linalg.solve(W, eye)
    return _CondFactors(mu_in=state.mu[:, ii], mu_out=state.mu[:, io],
                        winv_z=winv_z, prec_in=prec_in,
                        logdet_in=state.logdet + logdet_w,
                        wdiag_inv=torch.diagonal(winv, dim1=1, dim2=2))


def _factors(cfg: FIGMNConfig, state: FIGMNState, targets) -> _CondFactors:
    """THE factor stage every read runs (cached or not)."""
    idx_in, idx_out = _split_indices(cfg.dim, targets)
    return _conditional_factors(state, idx_in, idx_out)


def _dense_block(f: _CondFactors, ni: int, sp: Tensor, active: Tensor,
                 xb: Tensor, return_var: bool = False) -> Tensor:
    """The dense eq. 27 block body.  return_var stacks the conditional
    variance as a second row (law of total variance over the posterior
    mixture: Σ post_k (diag(W⁻¹)_k + x̂_k²) − x̂²)."""
    diff = xb[:, None, :] - f.mu_in[None, :, :]          # (B, K, i)
    xhat = f.mu_out[None, :, :] - torch.einsum("koi,bki->bko", f.winv_z,
                                               diff)
    t = torch.einsum("kij,bkj->bki", f.prec_in, diff)
    d2 = torch.einsum("bki,bki->bk", diff, t)
    logp = -0.5 * (ni * _LOG_2PI + f.logdet_in[None, :] + d2)
    post = figmn.masked_posteriors(logp, sp, active)
    mean = torch.einsum("bk,bko->bo", post, xhat)
    if not return_var:
        return mean
    ex2 = torch.einsum("bk,bko->bo", post,
                       f.wdiag_inv[None, :, :] + xhat * xhat)
    return torch.stack([mean, torch.clamp_min(ex2 - mean * mean, 0.0)],
                       dim=1)


def _map_blocks(block, xs: Tensor, block_b: int) -> Tensor:
    """Run ``block`` over fixed (block_b, ·) tiles of ``xs`` (bounds peak
    memory; rows are independent, so the tiling never changes a row)."""
    return torch.cat([block(xs[i:i + block_b])
                      for i in range(0, xs.shape[0], block_b)])


def _unstack_var(out: Tensor, return_var: bool):
    if not return_var:
        return out
    return out[:, 0, :], out[:, 1, :]


def _empty_result(cfg: FIGMNConfig, o: int, return_var: bool,
                  device: torch.device):
    """B = 0: well-formed (0, o) outputs, no kernel launched."""
    z = torch.zeros((0, o), dtype=cfg.dtype, device=device)
    return (z, z) if return_var else z


def predict_batch(cfg: FIGMNConfig, state: FIGMNState, xs_in, idx_out,
                  return_var: bool = False,
                  factors: Optional[_CondFactors] = None,
                  block_b: int = 512):
    """(B, o) conditional means: factor stage + blocked batch stage.

    ``xs_in`` carries the known dims in index order.  return_var=True also
    returns the (B, o) conditional variance as a (mean, var) pair.
    ``factors`` injects a precomputed (typically cached) bundle."""
    require_nonempty(state)
    xs_in = torch.as_tensor(xs_in, dtype=cfg.dtype, device=state.device)
    targets = _as_targets(idx_out)
    if xs_in.shape[0] == 0:
        return _empty_result(cfg, len(targets), return_var, state.device)
    f = factors if factors is not None else _factors(cfg, state, targets)
    ni = f.mu_in.shape[1]

    def block(xb: Tensor) -> Tensor:
        return _dense_block(f, ni, state.sp, state.active, xb, return_var)

    return _unstack_var(_map_blocks(block, xs_in, block_b), return_var)


def predict(cfg: FIGMNConfig, state: FIGMNState, x_in, idx_out) -> Tensor:
    """Reconstruct x[idx_out] from x_in (the remaining dims, in order)."""
    x_in = torch.as_tensor(x_in, dtype=cfg.dtype, device=state.device)
    return predict_batch(cfg, state, x_in[None, :], idx_out)[0]


def predict_batch_routed(cfg: FIGMNConfig, state: FIGMNState, xs_in,
                         idx_out, c: int = 0, return_var: bool = False,
                         factor_cache: Optional["FactorCache"] = None,
                         epoch: Optional[int] = None):
    """THE dense/sparse conditional dispatch: c > 0 routes through the
    shortlisted block, c <= 0 through the dense one.  ``factor_cache`` +
    ``epoch`` reuse the factor stage for every read against one epoch."""
    require_nonempty(state)
    xs_in = torch.as_tensor(xs_in, dtype=cfg.dtype, device=state.device)
    targets = _as_targets(idx_out)
    if xs_in.shape[0] == 0:
        return _empty_result(cfg, len(targets), return_var, state.device)
    factors = (factor_cache.get(cfg, state, targets, epoch)
               if factor_cache is not None and epoch is not None else None)
    if c > 0:
        return predict_batch_sparse(cfg, state, xs_in, targets, c=c,
                                    return_var=return_var, factors=factors)
    return predict_batch(cfg, state, xs_in, targets, return_var=return_var,
                         factors=factors)


def _sparse_block(cfg: FIGMNConfig, f: _CondFactors, ni: int, sp: Tensor,
                  active: Tensor, xb: Tensor, c: int, bound,
                  return_var: bool) -> Tensor:
    """The shortlisted eq. 27 block body: the bound pass on the known-block
    marginal, top-C, and the exact work on the (B, C) pairs.  The (B, C)
    Schur-complement products go through ``shortlist.gathered_products``
    (the ``gathered_matvec`` kernel on the card)."""
    diag_in, bias, dmu, m2, mu2 = bound
    if cfg.shortlist_mode == "euclid":
        proxy = -0.5 * (torch.sum(xb * xb, dim=1)[:, None]
                        - 2.0 * (xb @ f.mu_in.T) + mu2[None, :])
    else:
        d2_diag = (xb * xb) @ diag_in.T - 2.0 * (xb @ dmu.T) + m2[None, :]
        proxy = bias[None, :] - 0.5 * d2_diag
    proxy = torch.where(active[None, :], proxy,
                        torch.full_like(proxy, -torch.inf))
    idx = shortlist.topc(proxy, c)                        # (B, C)
    diff = xb[:, None, :] - f.mu_in[idx]                  # (B, C, i)
    xhat = f.mu_out[idx] - torch.einsum("bcoi,bci->bco", f.winv_z[idx],
                                        diff)
    t = shortlist.gathered_products(f.prec_in, diff, idx)
    d2 = torch.einsum("bci,bci->bc", diff, t)
    logp = -0.5 * (ni * _LOG_2PI + f.logdet_in[idx] + d2)
    post = figmn.masked_posteriors(logp, sp[idx], active[idx])
    mean = torch.einsum("bc,bco->bo", post, xhat)
    if not return_var:
        return mean
    ex2 = torch.einsum("bc,bco->bo", post, f.wdiag_inv[idx] + xhat * xhat)
    return torch.stack([mean, torch.clamp_min(ex2 - mean * mean, 0.0)],
                       dim=1)


def predict_batch_sparse(cfg: FIGMNConfig, state: FIGMNState, xs_in,
                         idx_out, c: Optional[int] = None,
                         block_b: int = 512, return_var: bool = False,
                         factors: Optional[_CondFactors] = None):
    """(B, o) conditional means with a top-C component shortlist.

    An O(K·i) bound pass on the known-block marginal (diag of the
    Schur-complement precision, the marginal logdet and the log-prior)
    ranks the slots per point; eq. 27 runs on the C shortlisted rows only.
    With C covering the pool the shortlist would be the identity
    permutation, so the dense block body runs instead: bit-identical to
    ``predict_batch`` at any batch size.
    """
    require_nonempty(state)
    kpool = int(state.active.shape[0])
    c = min(int(cfg.shortlist_c if c is None else c), kpool)
    if c <= 0:
        raise ValueError("predict_batch_sparse needs a positive shortlist "
                         "width (cfg.shortlist_c or the c argument)")
    xs_in = torch.as_tensor(xs_in, dtype=cfg.dtype, device=state.device)
    targets = _as_targets(idx_out)
    if xs_in.shape[0] == 0:
        return _empty_result(cfg, len(targets), return_var, state.device)
    f = factors if factors is not None else _factors(cfg, state, targets)
    ni = f.mu_in.shape[1]
    if c >= kpool:
        def block(xb: Tensor) -> Tensor:
            return _dense_block(f, ni, state.sp, state.active, xb,
                                return_var)
    else:
        diag_in = torch.diagonal(f.prec_in, dim1=1, dim2=2)   # (K, i)
        dmu = diag_in * f.mu_in
        bound = (diag_in,
                 -0.5 * f.logdet_in
                 + torch.log(torch.clamp_min(state.sp, 1e-30)),
                 dmu, torch.sum(dmu * f.mu_in, dim=1),
                 torch.sum(f.mu_in * f.mu_in, dim=1))

        def block(xb: Tensor) -> Tensor:
            return _sparse_block(cfg, f, ni, state.sp, state.active, xb, c,
                                 bound, return_var)

    return _unstack_var(_map_blocks(block, xs_in, block_b), return_var)


class FactorCache:
    """Per-(epoch, targets) LRU of eq. 27 factor bundles.

    A state only changes when its epoch moves, so the bundle is built once
    per (epoch, targets) and every later read against that epoch pays only
    the batch stage.  Cached and uncached reads run the same two stages on
    the same tensors, so their results are identical.  Thread-safe; a
    concurrent double build of one key is benign.  capacity <= 0 disables
    caching."""

    def __init__(self, capacity: int = 16):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[int, Tuple[int, ...]], _CondFactors]" \
            = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, cfg: FIGMNConfig, state: FIGMNState, idx_out,
            epoch: int) -> _CondFactors:
        """The factor bundle for (epoch, targets), building on a miss."""
        targets = _as_targets(idx_out)
        if self.capacity <= 0:
            return _factors(cfg, state, targets)
        key = (int(epoch), targets)
        with self._lock:
            f = self._entries.get(key)
            if f is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return f
            self.misses += 1
        f = _factors(cfg, state, targets)       # build outside the lock
        with self._lock:
            self._entries[key] = f
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return f

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
