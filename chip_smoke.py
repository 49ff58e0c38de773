#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

  1. device: the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` with nvcc.
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with the stated tolerance; then its
     time (CUDA events, median), its bound, the plain version's time and
     one library call's time where one computes the same function.  The
     resident kernel over a grid of blocks (``figmn_stream_grid``) is
     checked at the phase 2 shape with a forced 3-block plan and at the
     TPU kernel's design point (K = 32, D = 256, 8 MiB of Λ): equal
     accepts, μ/Λ/logdet/sp within 16·√(N·D)·u of their scale, two wrong
     variants (one block's d² partial dropped; one block's Λ rows left
     un-updated for one point) that must fail that check, two launches
     bit-equal.
  3. the main path at full width: ``Mixture.partial_fit`` /
     ``score_samples`` / ``predict_proba`` over an mnist-subset-shaped
     stream (N = 1000, 784 features + 10 one-hot labels, D = 794) with
     K = 64 and ``backend="pallas"`` on the scan path; the learner held
     against its plain-torch backend on a 128-point prefix.
  4. the resident path: a StreamRuntime at K = 16, D = 32 whose "auto" path
     must resolve to the resident kernel, held against the plain resident
     loop replayed on the card.
  4b. the resident path on pools beyond one block: StreamRuntime with
     ``benchmarks/figmn_runtime.py``'s stream, FIGMNConfig and lifecycle
     (every 8 chunks, budget K) at K = 32, D = 256 and at K = 32, D = 64,
     chunk 128, N = 2048; "auto" must resolve to "vmem" and launch
     ``figmn_stream_grid``; points/s, the chunk ms, accepts and the
     lifecycle counts; the same runtime with the plain loop in the
     kernel's place must agree (counts equal, states within the limit),
     and with either wrong variant in its first resident chunk must not
     (these replays stop after the first lifecycle pass and are held
     against the plain replay there); then the "scan" body these pools
     ran before, over 384 points, for comparison.
  5. the top-C shortlist path at full width: the phase 3 stream with
     ``shortlist_c = 8``, whose "auto" path must resolve to "sparse";
     ``partial_fit`` (one gathered_matvec and one scatter_apply launch per
     point), the shortlisted ``score_samples`` / ``predict_proba``, a
     sync-free ``fit_sparse`` chunk, the kernel backend against the plain
     one, the shortlisted reads against the plain reads, and a profile.
  6. flash-attention forward, kernel against plain on the card: small
     cases (d 16-128, ragged, T != S, causal and not, windows) in float32
     and bfloat16, then the scoring shape (B = 1, T = S = 8192, 32 heads
     over 8 KV heads, d = 80, window 4096) with per-row limits shown to
     fail a kernel that drops one 64-key tile; times against its bound,
     the plain version and ``scaled_dot_product_attention`` with the same
     mask.
  6b. flash-attention backward, ``flash_bwd_dq`` and ``flash_bwd_dkv``
     against their plain versions: phase 6's small cases with three keys
     hidden (rows that see no key), float32 and bfloat16, then the scoring
     shape in bfloat16 with per-row limits shown to fail three wrong
     backwards (a 64-key tile dropped from dq, a 64-row query tile dropped
     from dk and dv, dk and dv from the first query head of each group
     only); two launches bit-equal; times against their bounds, the plain
     versions and the backward of ``scaled_dot_product_attention``.
  7. scoring at full width: h2o-danube-1.8b (24 layers, d_model 2560, bf16,
     seeded init on the card), ``loss_fn`` over one SyntheticTokens batch
     of 8192 tokens under ``no_grad`` with ``ATTN_IMPL = "flash"``: 24
     flash_fwd launches a forward, a finite loss, tokens/s, peak memory,
     the kernel's share of the device time; then 2 layers of that width
     through "flash" and through the plain attention, with a limit on the
     logits shown to fail with one key tile hidden.
  8. generation at full width: ``ServeEngine`` (4 slots, a 4096-token
     cache) over 8 requests of 256-3000 prompt tokens and 16 new tokens
     each, the plain cached attention (no flash launch, as in the
     reference); prefill and decode times; the engine's first-token
     logits of the 3000-token prompt against ``forward_train``'s (flash),
     with the same dropped-tile control.
  9. the loss gradient at full width: ``train.trainer._grads`` (the port
     of ``jax.value_and_grad(loss_fn)``) of h2o-danube-1.8b over the
     scoring batch with ``ATTN_IMPL = "flash"`` and per-layer remat: loss,
     global grad norm, the median ms of 3 gradients after a warm-up, peak
     memory, launches (48 flash_fwd, 24 flash_bwd_dq, 24 flash_bwd_dkv a
     gradient), the backward kernels' share of a profiled gradient; held
     leaf by leaf against the same gradient through the plain attention,
     with a limit that each wrong backward of 6b must fail on 2 layers.
  10. one JSON line with every kernel (and each phase's wall seconds), the
     card line, and the result line.

Imports neither JAX nor the reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside
# the tensor cores, 989 TFLOP/s dense bf16 on the tensor cores; at 700 W.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
EPS32 = 2.0 ** -24
EPS_BF16 = 2.0 ** -8           # bf16's unit roundoff (8 significant bits)


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


_L2_FLUSH = None


def flush_l2() -> None:
    """Overwrite the 50 MB L2 cache with 128 MB of other data."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(32 * 2 ** 20, device="cuda")
    _L2_FLUSH.zero_()


def time_ms(fn, reps: int, warmup: int = 2, cold: bool = False) -> float:
    """Median milliseconds of one call of ``fn`` on the card (CUDA events
    around each call).  ``cold`` flushes the L2 cache before each call,
    outside the timed events, for work that would otherwise sit in it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for their type (float32 unless given),
    whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def stream_bound(n: int, d: int, k: int, ka: int, nacc: int):
    """The resident kernels' bound for an n-point chunk over a pool of k
    slots, ka of them active, nacc points accepted: the operations this
    run's data needs (the gate matvec and d² of every point, the rank-one
    update and μ step of the accepted ones, each over the active slots
    only: an inactive slot's μ and Λ come back unchanged), and the bytes
    of the points, the active slots' μ, Λ, logdet and sp read and written,
    the active mask and the accept count."""
    flops = n * (2 * ka * d * d + 2 * ka * d) \
        + nacc * (4 * ka * d * d + 2 * ka * d)
    nbytes = 4 * (n * d + 2 * (ka * d * d + ka * d + 2 * ka) + k + 1)
    return bound_ms(nbytes, flops)


def check_close(name: str, err: float, tol: float) -> None:
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} exceeds {tol}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(dev, warm):
    from repro_torch.kernels import (_build, figmn_sparse, figmn_stream,
                                     figmn_update, mahalanobis, ref)
    from repro_torch.core import figmn
    from repro_torch.core.types import FIGMNConfig, gate_threshold

    rows = {}
    g = torch.Generator(device=dev).manual_seed(0)
    k, d = 64, 794
    lam = torch.randn((k, d, d), generator=g, device=dev)
    a = torch.randn((k, d), generator=g, device=dev)
    b = torch.randn((k, d), generator=g, device=dev)

    log(f"matvec2 at K={k} D={d}")
    # worst-case summation error of any order is D·u·Σ|terms| (γ_D); two
    # orders differ by at most twice that
    tol = 2 * d * EPS32 * float(torch.einsum("kde,ke->kd", lam.abs(),
                                             a.abs()).max())
    y, _ = figmn_update.matvec2(lam, a)
    y2, z2 = figmn_update.matvec2(lam, a, b)
    err = max(max_err(y, ref.matvec_ref(lam, a)),
              max_err(y2, ref.matvec_ref(lam, a)),
              max_err(z2, ref.matvec_ref(lam, b)))
    check_close("matvec2", err, tol)
    nbytes, flops = 4 * (k * d * d + 2 * k * d), 2 * k * d * d
    bms, by = bound_ms(nbytes, flops)
    rows["matvec2"] = dict(
        name="matvec2", route="cuda",
        source="src/repro_torch/kernels/csrc/figmn_update.cu",
        replaces="src/repro/kernels/figmn_update.py:48",
        max_abs_err=err,
        ms=time_ms(lambda: figmn_update.matvec2(lam, a), 20),
        plain_ms=time_ms(lambda: ref.matvec_ref(lam, a), 20),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.bmm(lam, a[:, :, None]), 20),
        library_call="torch.bmm")

    log(f"rank2_apply at K={k} D={d}")
    w = torch.rand((k,), generator=g, device=dev) * 0.5
    inv1mw, c1, c2 = 1.0 / (1.0 - w), w, 0.5 * w
    out = figmn_update.rank2_apply(lam, a, None, inv1mw, c1, None)
    err = max_err(out, ref.rank2_apply_ref(lam, a, None, inv1mw, c1, None))
    out2 = figmn_update.rank2_apply(lam, a, b, inv1mw, c1, c2)
    err = max(err, max_err(out2, ref.rank2_apply_ref(lam, a, b, inv1mw, c1,
                                                     c2)))
    # same association, no multiply-add contraction: the two round alike
    check_close("rank2_apply", err, 4 * EPS32 * float(out2.abs().max()))
    # timed in place, as the main path runs it, with coefficients that keep
    # Λ bounded over the repeats
    lam_t = lam.clone()
    one, small = torch.ones_like(w), 1e-6 * w
    nbytes, flops = 4 * (2 * k * d * d + k * d + 2 * k), 3 * k * d * d
    bms, by = bound_ms(nbytes, flops)
    rows["rank2_apply"] = dict(
        name="rank2_apply", route="cuda",
        source="src/repro_torch/kernels/csrc/figmn_update.cu",
        replaces="src/repro/kernels/figmn_update.py:97",
        max_abs_err=err,
        ms=time_ms(lambda: figmn_update.rank2_apply(
            lam_t, a, None, one, small, None, out=lam_t), 20),
        plain_ms=time_ms(lambda: ref.rank2_apply_ref(
            lam_t, a, None, one, small, None), 20),
        bound_ms=bms, bound_by=by, library_ms=None)

    c = 8
    log(f"gathered_matvec at K={k} D={d} C={c} (cold L2)")
    idx = torch.randperm(k, generator=g, device=dev)[:c].to(torch.int32)
    diff = torch.randn((c, d), generator=g, device=dev)
    ys = figmn_sparse.gathered_matvec(lam, diff, idx)
    err = max_err(ys, ref.gathered_matvec_ref(lam, diff, idx))
    check_close("gathered_matvec", err, 2 * d * EPS32 * float(torch.einsum(
        "kde,ke->kd", lam[idx.long()].abs(), diff.abs()).max()))
    rows_sel = lam[idx.long()].contiguous()
    nbytes, flops = 4 * (c * d * d + 2 * c * d) + 4 * c, 2 * c * d * d
    bms, by = bound_ms(nbytes, flops)
    rows["gathered_matvec"] = dict(
        name="gathered_matvec", route="cuda",
        source="src/repro_torch/kernels/csrc/figmn_sparse.cu",
        replaces="src/repro/kernels/figmn_sparse.py:47",
        max_abs_err=err,
        ms=time_ms(lambda: figmn_sparse.gathered_matvec(lam, diff, idx), 20,
                   cold=True),
        plain_ms=time_ms(lambda: ref.gathered_matvec_ref(lam, diff, idx),
                         20, cold=True),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.bmm(rows_sel, diff[:, :, None]),
                           20, cold=True),
        library_call="torch.bmm on rows gathered beforehand")
    warm["gathered_matvec_ms"] = time_ms(
        lambda: figmn_sparse.gathered_matvec(lam, diff, idx), 20)

    log(f"scatter_apply at K={k} D={d} C={c} (cold L2)")
    coefs = torch.stack([1.0 / (1.0 - w[:c]), w[:c]], dim=1).contiguous()
    got_s = figmn_sparse.scatter_apply(lam.clone(), ys, coefs, idx)
    want_s = ref.scatter_apply_ref(lam.clone(), ys, coefs, idx)
    rest = torch.ones(k, dtype=torch.bool, device=dev)
    rest[idx.long()] = False
    if not torch.equal(got_s[rest], lam[rest]):
        raise AssertionError("scatter_apply touched a row outside idx")
    # same association, no multiply-add contraction: bit-equal
    err = max_err(got_s, want_s)
    check_close("scatter_apply (bit-equal; K-C rows untouched)", err, 0.0)
    del got_s, want_s
    lam_t = lam.clone()
    small = torch.stack([torch.ones_like(w[:c]), 1e-6 * w[:c]], dim=1)
    nbytes = 4 * (2 * c * d * d + c * d + 2 * c) + 4 * c
    bms, by = bound_ms(nbytes, 3 * c * d * d)
    rows["scatter_apply"] = dict(
        name="scatter_apply", route="cuda",
        source="src/repro_torch/kernels/csrc/figmn_sparse.cu",
        replaces="src/repro/kernels/figmn_sparse.py:77",
        max_abs_err=err,
        ms=time_ms(lambda: figmn_sparse.scatter_apply(lam_t, ys, small, idx),
                   20, cold=True),
        plain_ms=time_ms(lambda: ref.scatter_apply_ref(lam_t, ys, small,
                                                       idx), 20, cold=True),
        bound_ms=bms, bound_by=by, library_ms=None)
    warm["scatter_apply_ms"] = time_ms(
        lambda: figmn_sparse.scatter_apply(lam_t, ys, small, idx), 20)

    log(f"mahalanobis at K={k} D={d} (precision-like Λ)")
    # Λ as the learner keeps it, positive diagonal plus a low-rank PSD
    # part, so d² carries the sum and a dropped row shows above the bound
    del lam_t
    q = torch.randn((k, d, 8), generator=g, device=dev) / d ** 0.5
    lam_p = torch.diag_embed(0.5 + torch.rand((k, d), generator=g,
                                              device=dev))
    lam_p.baddbmm_(q, q.transpose(1, 2))
    del q
    d2 = mahalanobis.mahalanobis(a, lam_p)
    want = ref.mahalanobis_ref(a, lam_p)
    # each inner sum Λ_r·diff errs by at most γ_D·Σ_c|Λ_rc||diff_c|, the
    # outer sum by γ_D·Σ_r|diff_r·s_r|; two orders differ by twice that
    gamma = (d + 1) * EPS32 / (1 - (d + 1) * EPS32)
    s_rows = torch.einsum("kde,ke->kd", lam_p, a)
    tol_k = 2 * gamma * (torch.einsum("kd,kde,ke->k", a.abs(), lam_p.abs(),
                                      a.abs())
                         + (a * s_rows).abs().sum(dim=1))
    err = max_err(d2, want)
    worst = float(((d2 - want).abs() / tol_k).max())
    log(f"  mahalanobis: max_abs_err {err:.3e}; largest error over its "
        f"component's bound {worst:.3e} (tolerance 1)")
    if not worst <= 1.0:
        raise AssertionError(f"mahalanobis: error {worst} of its bound")
    # the bound must catch a row of mean weight (d²/D) left out of any Λ_k
    power = float((tol_k / (want / d)).max())
    log(f"  mahalanobis: largest bound is {power:.3f} of a mean row's term")
    if not power < 1.0:
        raise AssertionError("mahalanobis: the bound would pass a dropped row")
    if not torch.equal(d2, mahalanobis.mahalanobis(a, lam_p)):
        raise AssertionError("mahalanobis: repeated runs differ")
    nbytes, flops = 4 * (k * d * d + k * d + k), 2 * k * d * d + 2 * k * d
    bms, by = bound_ms(nbytes, flops)
    rows["mahalanobis"] = dict(
        name="mahalanobis", route="cuda",
        source="src/repro_torch/kernels/csrc/mahalanobis.cu",
        replaces="src/repro/kernels/mahalanobis.py:39",
        max_abs_err=err,
        ms=time_ms(lambda: mahalanobis.mahalanobis(a, lam_p), 20),
        plain_ms=time_ms(lambda: ref.mahalanobis_ref(a, lam_p), 20),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.einsum("kd,kde,ke->k", a, lam_p, a),
                           20),
        library_call="torch.einsum")
    del lam, lam_p, s_rows, out, out2, rows_sel

    kr, dr, n = 16, 32, 256
    log(f"figmn_stream at K={kr} D={dr} N={n}")
    if _build.lib().figmn_stream_smem_bytes(kr, dr) \
            != figmn_stream.smem_bytes(kr, dr):
        raise AssertionError("smem_bytes disagrees with the kernel's layout")
    x = torch.from_numpy(resident_stream(n + 512, dr, seed=1)).to(dev)
    cfg = FIGMNConfig(kmax=kr, dim=dr, beta=0.1, delta=1.0, vmin=1e9,
                      spmin=0.0, update_mode="exact",
                      sigma_ini=figmn.sigma_from_data(x, 1.0))
    st = figmn.fit(cfg, figmn.init_state(cfg, dev), x[:512])
    xs = x[512:].contiguous()
    args = (xs, st.mu, st.lam, st.logdet, st.sp, st.active.to(torch.int32),
            gate_threshold(cfg), dr)
    got = figmn_stream.figmn_stream(*args)
    want = ref.figmn_stream_ref(*args)
    if int(got[4][0]) != int(want[4][0]):
        raise AssertionError(f"accepts {int(got[4][0])} != "
                             f"{int(want[4][0])}")
    # tests/test_figmn_stream_kernel.py's tolerances: μ 2e-4, Λ 1e-3 (and
    # 1e-3 relative), logdet and sp 1e-3, over active slots
    m = st.active
    errs = [max_err(got[0][m], want[0][m]), max_err(got[1][m], want[1][m]),
            max_err(got[2][m], want[2][m]), max_err(got[3][m], want[3][m])]
    check_close("figmn_stream mu", errs[0], 2e-4)
    check_close("figmn_stream lam", errs[1],
                1e-3 + 1e-3 * float(want[1][m].abs().max()))
    check_close("figmn_stream logdet", errs[2], 1e-3)
    check_close("figmn_stream sp", errs[3], 1e-3)
    bms, by = stream_bound(n, dr, kr, int(st.n_active), int(got[4][0]))
    rows["figmn_stream"] = dict(
        name="figmn_stream", route="cuda",
        source="src/repro_torch/kernels/csrc/figmn_stream.cu",
        replaces="src/repro/kernels/figmn_stream.py:98",
        max_abs_err=max(errs),
        ms=time_ms(lambda: figmn_stream.figmn_stream(*args), 10),
        plain_ms=time_ms(lambda: ref.figmn_stream_ref(*args), 3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None)
    rows["figmn_stream_grid"] = grid_kernel_row(dev, args, st.active)
    for r in rows.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}; plain {r['plain_ms']:.4f} ms; library "
            f"{r['library_ms']} {r.get('library_call', '')})")
    return rows


def resident_stream(n: int, d: int, seed: int, modes: int = 4) -> np.ndarray:
    """benchmarks/figmn_runtime.py's stream: seeded clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 6.0, (modes, d))
    x = centers[rng.integers(0, modes, n)] + rng.normal(0, 1.0, (n, d))
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def full_width_stream(dev):
    """Table 1 mnist-subset shape: N = 1000, 784 features + 10 one-hot
    labels (D = 794), K = 64, β = 0.001, δ = 1, exact mode, kernels."""
    from repro_torch.core import figmn
    from repro_torch.core.types import FIGMNConfig
    from repro_torch.data.gmm_streams import gaussian_classes

    n, feats, classes = 1000, 784, 10
    x, y = gaussian_classes(n, feats, classes, seed=0)
    joint = np.concatenate([x, np.eye(classes, dtype=np.float32)[y]], 1)
    dim = feats + classes
    sigma = figmn.sigma_from_data(torch.from_numpy(joint).to(dev), 1.0)
    cfg = FIGMNConfig(kmax=64, dim=dim, beta=0.001, delta=1.0,
                      update_mode="exact", backend="pallas", sigma_ini=sigma)
    return n, classes, x, y, joint, list(range(feats, dim)), cfg


def timed(fn):
    """(result, seconds) on the host clock around work ending in a
    device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_full_width(dev):
    import dataclasses
    from repro_torch.api import Mixture, MixtureSpec
    from repro_torch.core import figmn
    from repro_torch.kernels import _build
    from repro_torch.stream import RuntimeConfig

    n, classes, x, y, joint, targets, cfg = full_width_stream(dev)
    dim = cfg.dim
    log(f"full width: N={n} D={dim} K={cfg.kmax} chunk=256 path=scan "
        f"backend=pallas")
    spec = MixtureSpec(model=cfg, runtime=RuntimeConfig(
        chunk=256, path="scan", device=str(dev)))
    # warm-up outside the counted run: loads the kernels and the library
    # handles (cuBLAS, cuSOLVER) a long-running service has loaded
    warm = Mixture(spec).partial_fit(joint[:32])
    warm.score_samples(joint[:32])
    warm.predict_proba(x[:32], targets)
    mix = Mixture(spec)

    _build.reset_launches()
    _, fit_s = timed(lambda: mix.partial_fit(joint))
    score, score_s = timed(lambda: mix.score_samples(joint))
    proba, predict_s = timed(lambda: mix.predict_proba(x, targets))
    launches = dict(_build.LAUNCHES)
    # repeats: score is stateless; predict_proba reuses the epoch's cached
    # factor stage, as a service's repeated reads do
    score_rep = statistics.median(
        timed(lambda: mix.score_samples(joint))[1] for _ in range(3))
    predict_rep = statistics.median(
        timed(lambda: mix.predict_proba(x, targets))[1] for _ in range(3))

    acc = float((proba.argmax(1).cpu().numpy() == y).mean())
    log(f"  active K {mix.n_active}, created {int(mix.state.n_created)}, "
        f"{n / fit_s:.1f} points/s ({fit_s:.3f} s), score {score_s * 1e3:.2f}"
        f" ms (repeat {score_rep * 1e3:.2f}), predict_proba "
        f"{predict_s * 1e3:.2f} ms (repeat, factors cached "
        f"{predict_rep * 1e3:.2f}), label accuracy {acc:.4f}")
    log(f"  launches on the main path: {launches}")
    if tuple(score.shape) != (n,) or not bool(torch.isfinite(score).all()):
        raise AssertionError("score_samples: not N finite values")
    if tuple(proba.shape) != (n, classes) \
            or not bool(torch.isfinite(proba).all()):
        raise AssertionError("predict_proba: not (N, 10) finite values")
    if launches["matvec2"] == 0 or launches["rank2_apply"] == 0:
        raise AssertionError(f"the main path missed its kernels: {launches}")

    # the kernel backend against the plain-torch backend on a prefix
    m = 128
    xs = torch.from_numpy(joint[:m]).to(dev)
    s_k = figmn.fit(cfg, figmn.init_state(cfg, dev), xs)
    s_p = figmn.fit(dataclasses.replace(cfg, backend="jnp"),
                    figmn.init_state(cfg, dev), xs)
    if int(s_k.n_created) != int(s_p.n_created):
        raise AssertionError("backends created different components")
    act = s_p.active
    check_close("full-width lam (kernels vs plain, 128 points)",
                max_err(s_k.lam[act], s_p.lam[act]),
                1e-3 * float(s_p.lam[act].abs().max()))
    check_close("full-width logdet", max_err(s_k.logdet[act],
                                             s_p.logdet[act]),
                1e-4 * float(s_p.logdet[act].abs().max()))
    check_close("full-width mu", max_err(s_k.mu[act], s_p.mu[act]),
                1e-4 * float(s_p.mu[act].abs().max()))
    profile_out = phase_profile(dev, cfg, torch.from_numpy(joint).to(dev))
    return launches, dict(profile=profile_out,
                          points_per_s=n / fit_s, score_ms=score_s * 1e3,
                          score_repeat_ms=score_rep * 1e3,
                          predict_ms=predict_s * 1e3,
                          predict_repeat_ms=predict_rep * 1e3,
                          accuracy=acc, active_k=mix.n_active,
                          created=int(mix.state.n_created))


def phase_profile(dev, cfg, xs, fit=None, label="scan"):
    """Where the time goes on a full-width ingest path: 64 learning steps
    of ``fit`` (``figmn.fit`` unless given) under torch.profiler; device
    time by kernel and the device's busy share of the window's wall time
    (profiler overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import figmn

    fit = fit or figmn.fit
    state = fit(cfg, figmn.init_state(cfg, dev), xs[:64])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = fit(cfg, state, xs[64:128])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the CPU op rows also carry the device time
    # of the kernels they launched, and summing both would count it twice
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    by_name = {ev.key: ev.self_device_time_total for ev in kernels}
    busy = sum(by_name.values())
    n_launch = sum(ev.count for ev in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(points=64, wall_us=wall_us, device_busy_us=busy,
               busy_share=busy / wall_us if busy else None,
               kernel_launches=n_launch, top_kernels_us=dict(top))
    log(f"profile (64 full-width {label} steps): wall {wall_us:.0f} us, "
        f"device busy "
        f"{busy:.0f} us, {n_launch} kernel launches" if busy
        else "profile: device time not measured")
    for k, v in top:
        log(f"  {v:10.1f} us  {k[:90]}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the top-C shortlist path at full width
# ---------------------------------------------------------------------------

def phase_sparse(dev):
    import dataclasses
    from repro_torch import interop
    from repro_torch.api import Mixture, MixtureSpec
    from repro_torch.core import figmn, inference, shortlist
    from repro_torch.kernels import _build
    from repro_torch.stream import RuntimeConfig

    n, classes, x, y, joint, targets, cfg = full_width_stream(dev)
    # C of the repo's shortlist acceptance point
    # (benchmarks/figmn_sparse.py:45-46)
    cfg = dataclasses.replace(cfg, shortlist_c=8)
    spec = MixtureSpec(model=cfg, runtime=RuntimeConfig(
        chunk=256, path="auto", device=str(dev)))
    warm = Mixture(spec)
    log(f"sparse: N={n} D={cfg.dim} K={cfg.kmax} C={cfg.shortlist_c} "
        f"chunk=256 path 'auto' -> {warm.engine.path!r}")
    if warm.engine.path != "sparse":
        raise AssertionError(f"'auto' resolved to {warm.engine.path!r}, "
                             "not 'sparse'")
    warm.partial_fit(joint[:32])
    warm.score_samples(joint[:32])
    warm.predict_proba(x[:32], targets)
    mix = Mixture(spec)

    _build.reset_launches()
    _, fit_s = timed(lambda: mix.partial_fit(joint))
    fit_launches = dict(_build.LAUNCHES)
    score, score_s = timed(lambda: mix.score_samples(joint))
    proba, predict_s = timed(lambda: mix.predict_proba(x, targets))
    launches = dict(_build.LAUNCHES)
    score_rep = statistics.median(
        timed(lambda: mix.score_samples(joint))[1] for _ in range(3))
    predict_rep = statistics.median(
        timed(lambda: mix.predict_proba(x, targets))[1] for _ in range(3))
    acc = float((proba.argmax(1).cpu().numpy() == y).mean())
    log(f"  active K {mix.n_active}, created {int(mix.state.n_created)}, "
        f"{n / fit_s:.1f} points/s ({fit_s:.3f} s), score {score_s * 1e3:.2f}"
        f" ms (repeat {score_rep * 1e3:.2f}), predict_proba "
        f"{predict_s * 1e3:.2f} ms (repeat, factors cached "
        f"{predict_rep * 1e3:.2f}), label accuracy {acc:.4f}")
    log(f"  launches: partial_fit {fit_launches}; with the reads {launches}")
    for name in ("gathered_matvec", "scatter_apply"):
        if fit_launches[name] != n:
            raise AssertionError(f"{name}: {fit_launches[name]} launches in "
                                 f"partial_fit, want one per point ({n})")
    if launches["gathered_matvec"] <= n:
        raise AssertionError("the shortlisted reads missed gathered_matvec")
    if tuple(score.shape) != (n,) or not bool(torch.isfinite(score).all()):
        raise AssertionError("score_samples: not N finite values")
    if tuple(proba.shape) != (n, classes) \
            or not bool(torch.isfinite(proba).all()):
        raise AssertionError("predict_proba: not (N, 10) finite values")

    # no host sync inside a sparse chunk
    xs = torch.from_numpy(joint).to(dev)
    st = mix.state.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = shortlist.fit_sparse(cfg, st, xs[:256])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("  fit_sparse over 256 points under set_sync_debug_mode('error'): "
        "no sync")

    # the kernel backend against the plain backend on a prefix (the phase 3
    # tolerances)
    m = 128
    plain = dataclasses.replace(cfg, backend="jnp")
    s_k = shortlist.fit_sparse(cfg, figmn.init_state(cfg, dev), xs[:m])
    s_p = shortlist.fit_sparse(plain, figmn.init_state(cfg, dev), xs[:m])
    if int(s_k.n_created) != int(s_p.n_created) \
            or not torch.equal(s_k.active, s_p.active):
        raise AssertionError("backends created different components")
    act = s_p.active
    check_close("sparse lam (kernels vs plain, 128 points)",
                max_err(s_k.lam[act], s_p.lam[act]),
                1e-3 * float(s_p.lam[act].abs().max()))
    check_close("sparse logdet", max_err(s_k.logdet[act], s_p.logdet[act]),
                1e-4 * float(s_p.logdet[act].abs().max()))
    check_close("sparse mu", max_err(s_k.mu[act], s_p.mu[act]),
                1e-4 * float(s_p.mu[act].abs().max()))

    # the shortlisted reads on the card (the gathered_matvec kernel) against
    # the plain read path (the wrapper's plain einsum) on CPU copies of the
    # state, 64 rows
    q = xs[:64]
    st_cpu = interop.state_from_numpy(interop.state_to_numpy(mix.state),
                                      "cpu")
    sk = shortlist.score_batch_sparse(cfg, mix.state, q)
    sp_ = shortlist.score_batch_sparse(cfg, st_cpu, q.cpu())
    check_close("sparse score (card kernel vs plain, 64 rows)",
                max_err(sk.cpu(), sp_), 1e-4 * float(sp_.abs().max()))
    pk = inference.predict_batch_sparse(cfg, mix.state, x[:64], targets)
    pp = inference.predict_batch_sparse(cfg, st_cpu, x[:64], targets)
    check_close("sparse predict (card kernel vs plain, 64 rows)",
                max_err(pk.cpu(), pp), 1e-3)
    profile_out = phase_profile(dev, cfg, xs, fit=shortlist.fit_sparse,
                                label="sparse")
    return launches, dict(profile=profile_out, points_per_s=n / fit_s,
                          score_ms=score_s * 1e3,
                          score_repeat_ms=score_rep * 1e3,
                          predict_ms=predict_s * 1e3,
                          predict_repeat_ms=predict_rep * 1e3,
                          accuracy=acc, active_k=mix.n_active,
                          created=int(mix.state.n_created))


# ---------------------------------------------------------------------------
# phase 4: the resident path
# ---------------------------------------------------------------------------

def phase_resident(dev):
    from repro_torch.core import figmn
    from repro_torch.core.types import FIGMNConfig, FIGMNState, gate_threshold
    from repro_torch.kernels import _build, ref
    from repro_torch.stream import RuntimeConfig, StreamRuntime

    n, d, k, chunk = 2048, 32, 16, 256
    x = resident_stream(n, d, seed=0)
    cfg = FIGMNConfig(kmax=k, dim=d, beta=0.1, delta=1.0, vmin=50.0,
                      spmin=1.0, update_mode="exact",
                      sigma_ini=figmn.sigma_from_data(
                          torch.from_numpy(x), 1.0).numpy())
    rt = StreamRuntime(cfg, RuntimeConfig(chunk=chunk, path="auto",
                                          device=str(dev)))
    log(f"resident: N={n} D={d} K={k} chunk={chunk}: path {rt.path!r}")
    if rt.path != "vmem":
        raise AssertionError(f"'auto' resolved to {rt.path!r}, not 'vmem'")
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = rt.ingest(x)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    vmem_chunk_ms = statistics.median(
        m.latency_s * 1e3 for m in rt.telemetry.history if m.path == "vmem")
    log(f"  {n / ingest_s:.1f} points/s, a resident chunk {vmem_chunk_ms:.3f}"
        f" ms, active K {summary['active_k']}, "
        f"accepted {summary['accepted']}, paths "
        f"{[m.path for m in rt.telemetry.history]}, launches {launches}")
    if launches["figmn_stream"] == 0:
        raise AssertionError("the resident path missed its kernel")

    # replay the runtime's chunks with the plain resident loop on the card
    st = figmn.init_state(cfg, dev)
    thresh, accepted = gate_threshold(cfg), 0
    for a in range(0, n, chunk):
        xc = torch.from_numpy(x[a:a + chunk]).to(dev)
        if int(st.n_active) == 0:
            st = figmn.fit(cfg, st, xc, do_prune=cfg.spmin > 0)
            continue
        mu, lam, logdet, sp, nacc = ref.figmn_stream_ref(
            xc, st.mu, st.lam, st.logdet, st.sp, st.active.to(torch.int32),
            thresh, d)
        accepted += int(nacc[0])
        st = FIGMNState(mu=mu, lam=lam, logdet=logdet, sp=sp,
                        v=st.v + xc.shape[0] * st.active.to(cfg.dtype),
                        active=st.active, n_created=st.n_created)
    if accepted != summary["accepted"]:
        raise AssertionError(f"accepts {summary['accepted']} != {accepted}")
    m = st.active
    if not torch.equal(m, rt.state.active):
        raise AssertionError("active slots differ from the plain replay")
    check_close("resident mu", max_err(rt.state.mu[m], st.mu[m]), 2e-4)
    check_close("resident lam", max_err(rt.state.lam[m], st.lam[m]),
                1e-3 + 1e-3 * float(st.lam[m].abs().max()))
    check_close("resident sp", max_err(rt.state.sp[m], st.sp[m]), 1e-3)
    return launches, dict(points_per_s=n / ingest_s,
                          vmem_chunk_ms=vmem_chunk_ms)


# ---------------------------------------------------------------------------
# the resident kernel over a grid of blocks (phases 2 and 4b)
# ---------------------------------------------------------------------------

RESIDENT_SIGMAS = 16
# (K, D, points) of the grid kernel's check and time in phase 2: the TPU
# kernel's design point, 8 MiB of Λ (src/repro/kernels/figmn_stream.py:4-6)
GRID_KERNEL_SHAPE = (32, 256, 256)
STATE_NAMES = ("mu", "lam", "logdet", "sp")


def resident_limit(n: int, d: int) -> float:
    """The resident state's limit, kernel (or runtime) against the plain
    loop, relative to each quantity's largest magnitude over the active
    slots: the two summation orders of y, d² and the posterior's
    normaliser differ by about √D·u per D-term sum, and the difference
    walks over the N sequential points: 16·√(N·D)·u (a 16σ margin)."""
    return RESIDENT_SIGMAS * (n * d) ** 0.5 * EPS32


def stream_fault(args, plan, kind: str):
    """The plain resident loop with one fault the grid kernel could make,
    in the block (of ``plan``) that holds the middle row of the active
    component with the largest sp:

      "drop"  that block's d² partial never reaches the sum (every point);
      "skip"  that block's Λ rows keep their values at the first accepted
              point whose largest posterior is that component's.
    """
    from repro_torch.kernels import figmn_stream
    from repro_torch.kernels.ref import _LOG_2PI, matvec_ref

    xs, mu, lam, logdet, sp, active, thresh, dim = args
    k, d = mu.shape
    act = active.bool()
    kt = int(torch.argmax(torch.where(act, sp, torch.full_like(sp, -1.0))))
    r0, nr = next((a, m) for a, m in figmn_stream.plan_blocks(plan, k, d)
                  if a <= kt * d + d // 2 < a + m)
    keep = torch.ones(k * d, device=xs.device)
    if kind == "drop":
        keep[r0:r0 + nr] = 0.0
    keep = keep.view(k, d)
    mu, lam, logdet, sp = mu.clone(), lam.clone(), logdet.clone(), sp.clone()
    nacc, skipped = 0, kind != "skip"
    for t in range(xs.shape[0]):
        diff = xs[t][None, :] - mu
        y = matvec_ref(lam, diff)
        d2 = (diff * y * keep).sum(dim=1)
        accept = bool(torch.any(act & (d2 < thresh)))
        logp = -0.5 * (dim * _LOG_2PI + logdet + d2)
        logw = torch.where(act, logp + torch.log(sp.clamp_min(1e-30)),
                           torch.full_like(logp, -1e30))
        p_un = torch.where(act, torch.exp(logw - logw.max()),
                           torch.zeros_like(logw))
        post = p_un / p_un.sum().clamp_min(1e-30) if accept \
            else torch.zeros_like(p_un)
        sp_new = sp + post
        w = post / sp_new.clamp_min(1e-30)
        beta = w / (1.0 + w * d2)
        new = (lam - (beta[:, None] * y)[:, None, :] * y[:, :, None]) \
            / (1.0 - w)[:, None, None]
        if not skipped and accept and int(torch.argmax(post)) == kt:
            new.view(-1, d)[r0:r0 + nr] = lam.view(-1, d)[r0:r0 + nr]
            skipped = True
        mu = mu + w[:, None] * diff
        lam = new
        logdet = logdet + (dim * torch.log(1.0 - w) + torch.log1p(w * d2))
        sp = sp_new
        nacc += accept
    return mu, lam, logdet, sp, torch.tensor([nacc], dtype=torch.int32,
                                             device=xs.device)


def resident_readings(got, want, active, limit: float) -> dict:
    """Each of μ, Λ, logdet, sp: the largest error over the active slots
    as a fraction of its limit (``limit`` · the quantity's scale)."""
    return {name: max_err(g[active], w[active])
            / (limit * float(w[active].abs().max()))
            for name, g, w in zip(STATE_NAMES, got, want)}


def check_resident(what: str, got, want, active, limit: float,
                   controls: dict, same=None, control_want=None) -> float:
    """``got`` (μ, Λ, logdet, sp) against the plain ``want`` within
    ``limit`` (``same``: counts as (got, plain) pairs that must be equal);
    then every wrong variant in ``controls`` (name → (its state, or None
    when its active slots moved; the counts that moved)) must fail that
    check, held against ``control_want`` (the plain state and active mask
    where the variants stopped) or else ``want``.  Returns the largest
    absolute error."""
    same = same or {}
    c_want, c_active = control_want or (want, active)
    bad = {k_: v for k_, v in same.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"{what}: counts differ (got, plain): {bad}")
    r = resident_readings(got, want, active, limit)
    log(f"  {what}: limit {limit:.3e} of the scale; errors over it "
        + ", ".join(f"{k_} {v:.3e}" for k_, v in r.items())
        + f"; counts {', '.join(f'{k_} {v[0]}' for k_, v in same.items())}")
    if not all(v <= 1.0 for v in r.values()):
        raise AssertionError(f"{what}: outside its limit: {r}")
    for kind, (state, moved) in controls.items():
        rb = {} if state is None \
            else resident_readings(state, c_want, c_active, limit)
        log(f"    wrong variant {kind!r}: over the limit "
            + (", ".join(f"{k_} {v:.3e}" for k_, v in rb.items())
               or "(active slots moved)")
            + f"; counts that moved (variant, plain) {moved}")
        if state is not None and not moved \
                and all(v <= 1.0 for v in rb.values()):
            raise AssertionError(f"{what}: the limits pass the wrong "
                                 f"variant {kind!r}")
    return max(max_err(g[active], w[active])
               for g, w in zip(got, want))


def grid_kernel_row(dev, small_args, small_active):
    """phase 2: figmn_stream_grid against its plain version at the phase 2
    shape with a forced 3-block plan (rows straddle components) and at the
    TPU kernel's design point (K = 32, D = 256, 8 MiB of Λ), each with
    both wrong variants and two launches bit-equal; then its time."""
    from repro_torch.core import figmn
    from repro_torch.core.types import FIGMNConfig, gate_threshold
    from repro_torch.kernels import _build, figmn_stream, ref

    smem = _build.smem_optin(dev)
    cap = figmn_stream.grid_capacity(dev, smem)
    log(f"figmn_stream_grid: {cap} co-resident blocks at {smem} bytes; "
        f"{_build.sm_count(dev)} SMs")

    def run_checks(what, args, active, plan):
        n, d = args[0].shape
        if _build.lib().figmn_stream_grid_smem_bytes(
                plan.rows, plan.nc, d) != plan.smem_bytes:
            raise AssertionError("grid_smem_bytes disagrees with the "
                                 "kernel's layout")
        got = figmn_stream.figmn_stream(*args, plan=plan)
        again = figmn_stream.figmn_stream(*args, plan=plan)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{what}: two launches differ")
        want = ref.figmn_stream_ref(*args)
        controls = {}
        for kind in ("drop", "skip"):
            bad = stream_fault(args, plan, kind)
            moved = {"accepts": (int(bad[4][0]), int(want[4][0]))}
            controls[kind] = (bad[:4], {k_: v for k_, v in moved.items()
                                        if v[0] != v[1]})
        err = check_resident(
            what, got[:4], want[:4], active, resident_limit(n, d), controls,
            same={"accepts": (int(got[4][0]), int(want[4][0]))})
        log(f"  {what}: two launches bit-equal")
        return err, int(got[4][0])

    kr, dr = small_active.shape[0], small_args[0].shape[1]
    plan3 = figmn_stream.grid_plan(kr, dr, smem, cap, blocks=3)
    log(f"figmn_stream_grid at K={kr} D={dr} N={small_args[0].shape[0]}, "
        f"forced {plan3}")
    err_small, _ = run_checks("figmn_stream_grid G=3", small_args,
                              small_active, plan3)
    small_ms = time_ms(lambda: figmn_stream.figmn_stream(*small_args,
                                                         plan=plan3), 10)

    k, d, n = GRID_KERNEL_SHAPE
    x = torch.from_numpy(resident_stream(n + 512, d, seed=2,
                                         modes=8)).to(dev)
    cfg = FIGMNConfig(kmax=k, dim=d, beta=0.1, delta=1.0, vmin=1e9,
                      spmin=0.0, update_mode="exact",
                      sigma_ini=figmn.sigma_from_data(x, 1.0))
    st = figmn.fit(cfg, figmn.init_state(cfg, dev), x[:512])
    args = (x[512:].contiguous(), st.mu, st.lam, st.logdet, st.sp,
            st.active.to(torch.int32), gate_threshold(cfg), d)
    plan = figmn_stream.resident_plan(k, d, dev)
    if plan is None:
        raise AssertionError(f"K={k} D={d} fits one block: no grid")
    log(f"figmn_stream_grid at K={k} D={d} N={n} ({int(st.n_active)} active"
        f" slots), {plan}")
    err, nacc = run_checks("figmn_stream_grid", args, st.active, plan)
    bms, by = stream_bound(n, d, k, int(st.n_active), nacc)
    row = dict(
        name="figmn_stream_grid", route="cuda",
        source="src/repro_torch/kernels/csrc/figmn_stream_grid.cu",
        replaces="src/repro/kernels/figmn_stream.py:98",
        max_abs_err=max(err, err_small),
        ms=time_ms(lambda: figmn_stream.figmn_stream(*args), 10),
        plain_ms=time_ms(lambda: ref.figmn_stream_ref(*args), 3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None)
    row.update(plan=dataclasses.asdict(plan), barriers_per_launch=n,
               g3_small_ms=small_ms)
    log(f"  figmn_stream_grid: {row['ms']:.4f} ms a {n}-point chunk, "
        f"{row['ms'] * 1e3 / n:.2f} us a point with one grid barrier each "
        f"over {plan.blocks} blocks; at K={kr} D={dr} with G=3 "
        f"{small_ms:.4f} ms")
    return row


@contextlib.contextmanager
def resident_body(fn):
    """Run the runtime's resident chunks through ``fn`` (the arguments of
    ``figmn_stream.figmn_stream``) in the kernels' place."""
    from repro_torch.kernels import figmn_stream

    kernel = figmn_stream.figmn_stream
    figmn_stream.figmn_stream = fn
    try:
        yield
    finally:
        figmn_stream.figmn_stream = kernel


def plain_body(*args, **_):
    """The plain resident loop, on the card, in the kernels' place."""
    from repro_torch.kernels import ref
    return ref.figmn_stream_ref(*args)


def faulty_body(plan, kind: str):
    """The plain loop, with ``stream_fault`` in the first resident chunk."""
    calls = []

    def fn(*args, **_):
        calls.append(1)
        if len(calls) == 1:
            return stream_fault(args, plan, kind)
        return plain_body(*args)
    return fn


class FirstPass(Exception):
    """Ends a replay after its first lifecycle pass."""


def state_fields(r):
    return [getattr(r.state, f) for f in STATE_NAMES]


def replay(cfg, rc, x, body, stop: bool = False):
    """``StreamRuntime(cfg, rc).ingest(x)`` with ``body`` in the resident
    kernels' place; also returns (the summary, the state, the active mask)
    just after its first lifecycle pass, and with ``stop`` ends there."""
    from repro_torch.stream import StreamRuntime

    with resident_body(body):
        r = StreamRuntime(cfg, rc)
        run, first = r._run_lifecycle, []

        def pass_and_snapshot():
            run()
            if not first:
                first.append((r.telemetry.summary(),
                              [t.clone() for t in state_fields(r)],
                              r.state.active.clone()))
                if stop:
                    raise FirstPass
        r._run_lifecycle = pass_and_snapshot
        try:
            r.ingest(x)
        except FirstPass:
            pass
    return r, first[0]


COUNTS = ("accepted", "created", "pruned", "merged", "spawned", "active_k")
GRID_CELLS = ((32, 256, "the TPU kernel's design point "
               "(src/repro/kernels/figmn_stream.py:4-6)"),
              (32, 64, "figmn_runtime's cell (benchmarks/figmn_runtime.py:27)"))


def phase_resident_grid(dev):
    """phase 4b: the resident path on pools beyond one block, through
    StreamRuntime with figmn_runtime's lifecycle; the runtime against the
    same runtime with the plain loop in the kernels' place; the "scan"
    body these pools ran before."""
    from repro_torch.core import figmn
    from repro_torch.core.types import FIGMNConfig
    from repro_torch.kernels import _build, figmn_stream
    from repro_torch.stream import (LifecycleConfig, RuntimeConfig,
                                    StreamRuntime)

    out, main_launches = {}, None
    n, chunk, n_scan = 2048, 128, 384
    for k, d, what in GRID_CELLS:
        # figmn_runtime's stream (k/4 modes) and FIGMNConfig
        x = resident_stream(n, d, seed=0, modes=max(k // 4, 2))
        cfg = FIGMNConfig(kmax=k, dim=d, beta=0.1, delta=1.0, vmin=50.0,
                          spmin=1.0, update_mode="exact",
                          sigma_ini=figmn.sigma_from_data(
                              torch.from_numpy(x), 1.0).numpy())
        rc = RuntimeConfig(chunk=chunk, device=str(dev),
                           lifecycle=LifecycleConfig(k_budget=k, every=8))
        plan = figmn_stream.resident_plan(k, d, dev)
        StreamRuntime(cfg, rc).ingest(x[:2 * chunk])          # warm-up
        rt = StreamRuntime(cfg, rc)
        log(f"resident grid: {what}: N={n} D={d} K={k} chunk={chunk}, "
            f"lifecycle every 8 chunks to {k}: path {rt.path!r}, {plan}")
        if rt.path != "vmem" or plan is None:
            raise AssertionError(f"'auto' resolved to {rt.path!r} with plan "
                                 f"{plan}, not the grid")
        _build.reset_launches()
        summary, s = timed(lambda: rt.ingest(x))
        launches = dict(_build.LAUNCHES)
        vmem = [m.latency_s * 1e3 for m in rt.telemetry.history
                if m.path == "vmem"]
        log(f"  {n / s:.1f} points/s ({s:.3f} s), a resident chunk "
            f"{statistics.median(vmem):.3f} ms (median of {len(vmem)}), "
            + ", ".join(f"{c} {summary[c]}" for c in COUNTS)
            + f", launches {launches}")
        if launches["figmn_stream_grid"] != len(vmem) or not vmem:
            raise AssertionError("the resident chunks missed the grid kernel")
        if main_launches is None:
            main_launches = launches

        plain, plain_first = replay(cfg, rc, x, plain_body)
        ps = plain.telemetry.summary()
        act = plain.state.active
        if not torch.equal(act, rt.state.active):
            raise AssertionError("active slots differ from the plain replay")
        # the faulty replays stop after the first lifecycle pass, where the
        # fault of their first resident chunk already shows
        pf_sum, pf_state, pf_act = plain_first
        controls = {}
        for kind in ("drop", "skip"):
            _, (bs, b_state, b_act) = replay(cfg, rc, x,
                                             faulty_body(plan, kind),
                                             stop=True)
            moved = {c: (bs[c], pf_sum[c]) for c in COUNTS
                     if bs[c] != pf_sum[c]}
            controls[kind] = (b_state if torch.equal(b_act, pf_act)
                              else None, moved)
        check_resident(f"resident grid K={k} D={d} vs plain replay",
                       state_fields(rt), state_fields(plain), act,
                       resident_limit(n, d), controls,
                       same={c: (summary[c], ps[c]) for c in COUNTS},
                       control_want=(pf_state, pf_act))

        # where a resident chunk's time goes: 4 more chunks into the formed
        # runtime (and its end-of-call lifecycle pass) under the profiler
        by_kernel, wall_us = device_time_by_kernel(
            lambda: rt.ingest(x[:4 * chunk]))
        busy = sum(by_kernel.values())
        grid_us = sum(v for k_, v in by_kernel.items()
                      if "figmn_stream_grid" in k_)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
        log(f"  profiled 4 resident chunks: wall {wall_us:.0f} us, device "
            f"busy {busy:.0f} us ({busy / wall_us:.3f}), figmn_stream_grid "
            f"{grid_us:.0f} us ({grid_us / wall_us:.3f} of the wall)")
        for k_, v in top:
            log(f"    {v:10.1f} us  {k_[:90]}")
        rs = StreamRuntime(cfg, dataclasses.replace(rc, path="scan"))
        rs.ingest(x[:chunk])                                   # warm-up
        rs = StreamRuntime(cfg, dataclasses.replace(rc, path="scan"))
        _, s_scan = timed(lambda: rs.ingest(x[:n_scan]))
        log(f"  before this slice, 'scan': {n_scan / s_scan:.1f} points/s "
            f"over {n_scan} points; the grid path {n / s:.1f} "
            f"({n / s / (n_scan / s_scan):.1f}x)")
        out[f"k{k}_d{d}"] = dict(
            points_per_s=n / s, vmem_chunk_ms=statistics.median(vmem),
            scan_points_per_s=n_scan / s_scan, plan=dataclasses.asdict(plan),
            profile=dict(chunks=4, wall_us=wall_us, device_busy_us=busy,
                         grid_kernel_us=grid_us,
                         top_kernels_us=dict(top)),
            grid_launches=launches["figmn_stream_grid"],
            **{c: summary[c] for c in COUNTS})
    return main_launches, out


# ---------------------------------------------------------------------------
# phase 6: flash-attention forward, kernel against plain
# ---------------------------------------------------------------------------

FLASH_SMALL = [
    # (B, T, S, H, KV, d, causal, window)
    (1, 33, 65, 2, 2, 16, False, 0),
    (2, 100, 100, 4, 2, 64, True, 0),
    (1, 77, 130, 4, 1, 80, True, 9),
    (1, 70, 190, 2, 2, 128, False, 17),
    (1, 129, 129, 2, 2, 80, True, 0),
]


# the scoring shape: B, T = S, heads, KV heads, head_dim, window — what
# every layer of h2o-danube-1.8b's forward gives the kernel at T = 8192
FLASH_MAIN = (1, 8192, 32, 8, 80, 4096)


def flash_inputs(dev, g, b, t, s, h, kv, d, dtype):
    q = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype)
    qp = torch.arange(s - t, s, dtype=torch.int32,
                      device=dev)[None].expand(b, t).contiguous()
    kp = torch.arange(s, dtype=torch.int32,
                      device=dev)[None].expand(b, s).contiguous()
    return q, k, v, qp, kp


def flash_limits(want, want_lse, n_keys: int):
    """Per-row limit on ||out − plain||₂ and the limit on |lse − plain|.

    bfloat16: each side rounds p (2⁻⁸ relative) and out (2⁻⁸); the p
    roundings are independent across keys, so over a weighted sum of
    random v they move the row by about 2⁻⁸ of its norm each: 4·2⁻⁸·‖row‖.
    float32: each side's running sums of n keys err by about u·√n of the
    row's norm: 8·u·√S·‖row‖ (u = 2⁻²⁴).  lse = m + log l, l a sum of at
    most S positive terms each within a few ulps: 2·(S + 4)·u + 4u·|lse|
    (worst case, both sides)."""
    norm = want.float().norm(dim=-1)
    if want.dtype == torch.bfloat16:
        row = 4 * EPS_BF16 * norm
    else:
        row = 8 * EPS32 * n_keys ** 0.5 * norm
    lse_tol = 2 * (n_keys + 4) * EPS32 + 4 * EPS32 * float(
        want_lse.abs().max())
    return row, lse_tol


def flash_worst(got, got_lse, want, want_lse, n_keys: int):
    """(largest row error over its limit, lse error over its limit)."""
    row, lse_tol = flash_limits(want, want_lse, n_keys)
    err = (got.float() - want.float()).norm(dim=-1)
    return float((err / row).max()), max_err(got_lse, want_lse) / lse_tol


def visible_pairs(qp, kp, window: int, causal: bool, heads: int) -> int:
    """(query, key) pairs that the mask lets through, over all heads."""
    total = 0
    for b in range(qp.shape[0]):
        for a in range(0, qp.shape[1], 1024):
            dpos = qp[b, a:a + 1024, None] - kp[b, None, :]
            m = (kp[b] >= 0)[None, :].expand_as(dpos)
            if causal:
                m = m & (dpos >= 0)
            if window > 0:
                m = m & (dpos < window)
            total += int(m.sum())
    return total * heads


def phase_flash(dev):
    from repro_torch.kernels import _build, flash_attention, ref

    g = torch.Generator(device=dev).manual_seed(14)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_SMALL:
            b, t, s, h, kv, d, causal, win = case
            q, k, v, qp, kp = flash_inputs(dev, g, b, t, s, h, kv, d, dtype)
            got, got_lse = flash_attention.flash_fwd(q, k, v, qp, kp, win,
                                                     causal)
            torch.cuda.synchronize()
            want, want_lse = ref.flash_fwd_ref(q, k, v, qp, kp, win, causal)
            w = flash_worst(got, got_lse, want, want_lse, s)
            worst[(str(dtype)[6:],) + case] = w
            if not max(w) <= 1.0:
                raise AssertionError(f"flash_fwd {dtype} {case}: error over "
                                     f"its limit (out, lse) {w}")
    log("flash_fwd small cases (B, T, S, H, KV, d, causal, window) in "
        "float32 and bfloat16: largest error over its limit (out rows, lse)")
    for key, w in worst.items():
        log(f"  {key}: {w[0]:.3e}, {w[1]:.3e}")

    b, t, h, kv, d, win = FLASH_MAIN
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        log(f"flash_fwd at the scoring shape B={b} T=S={t} H={h} KV={kv} "
            f"d={d} window={win} causal {str(dtype)[6:]}")
        q, k, v, qp, kp = flash_inputs(dev, g, b, t, t, h, kv, d, dtype)
        got, got_lse = flash_attention.flash_fwd(q, k, v, qp, kp, win)
        torch.cuda.synchronize()
        want, want_lse = ref.flash_fwd_ref(q, k, v, qp, kp, win)
        w_out, w_lse = flash_worst(got, got_lse, want, want_lse, t)
        err = max_err(got, want)
        log(f"  out: max_abs_err {err:.3e}; largest row error over its "
            f"limit {w_out:.3e}; lse: max_abs_err "
            f"{max_err(got_lse, want_lse):.3e}, over its limit {w_lse:.3e}")
        if not (w_out <= 1.0 and w_lse <= 1.0):
            raise AssertionError(f"flash_fwd {dtype}: error over its limit "
                                 f"(out {w_out}, lse {w_lse})")
        # the limits must catch a kernel that skips one 64-key tile
        kp_drop = kp.clone()
        kp_drop[:, win:win + 64] = -1
        drop, drop_lse = ref.flash_fwd_ref(q, k, v, qp, kp_drop, win)
        d_out, d_lse = flash_worst(drop, drop_lse, want, want_lse, t)
        log(f"  a tile dropped (keys {win}-{win + 63} hidden): largest row "
            f"error over the limit {d_out:.3e}, lse {d_lse:.3e}")
        if not (d_out > 1.0 and d_lse > 1.0):
            raise AssertionError("flash_fwd: the limits would pass a "
                                 "dropped tile")
        del drop, drop_lse, kp_drop, want, want_lse, got, got_lse
        if dtype != torch.bfloat16:
            continue
        pairs = visible_pairs(qp, kp, win, True, h)
        log(f"  visible (query, key) pairs {pairs:.4e} "
            f"({pairs / (h * t * t):.4f} of T·S·H)")
        # q and out at H heads, k and v at KV heads (bf16), each read or
        # written once, and the float32 lse; 4·d operations per pair
        nbytes = 2 * 2 * b * t * (h + kv) * d + 4 * b * h * t
        bms, by = bound_ms(nbytes, 4 * d * pairs, BF16_FLOP_PER_S)
        log(f"  bound: {4 * d * pairs:.4e} operations at 989 TFLOP/s bf16 "
            f"= {4 * d * pairs / BF16_FLOP_PER_S * 1e3:.4f} ms against "
            f"{nbytes:.4e} bytes at 3.35 TB/s = "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        args = (q, k, v, qp, kp, win)
        ms_cold = time_ms(lambda: flash_attention.flash_fwd(*args), 10,
                          cold=True)
        ms_warm = time_ms(lambda: flash_attention.flash_fwd(*args), 10)
        plain = time_ms(lambda: ref.flash_fwd_ref(*args), 3, warmup=1)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        dpos = qp[0][:, None] - kp[0][None, :]
        mask = (dpos >= 0) & (dpos < win)
        sdpa_fn = torch.nn.functional.scaled_dot_product_attention
        sdpa = time_ms(lambda: sdpa_fn(qs, ks, vs, attn_mask=mask,
                                       enable_gqa=True), 10, cold=True)
        # beside it, k and v expanded to H heads beforehand (not timed)
        ke, ve = (x.repeat_interleave(h // kv, dim=1) for x in (ks, vs))
        sdpa_mha = time_ms(lambda: sdpa_fn(qs, ke, ve, attn_mask=mask), 10,
                           cold=True)
        del qs, ks, vs, ke, ve, mask, dpos
        log(f"  flash_fwd {ms_cold:.3f} ms cold L2, {ms_warm:.3f} warm "
            f"(bound {bms:.4f} ms by {by}; plain {plain:.3f} ms; "
            f"scaled_dot_product_attention, same bool mask, enable_gqa "
            f"{sdpa:.3f} ms, on k and v expanded to {h} heads "
            f"{sdpa_mha:.3f} ms)")
        row = dict(
            name="flash_fwd", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:228",
            max_abs_err=err, ms=ms_cold, plain_ms=plain, bound_ms=bms,
            bound_by=by, library_ms=sdpa,
            library_call="scaled_dot_product_attention with a bool mask "
                         "and enable_gqa",
            library_expanded_kv_ms=sdpa_mha, warm_l2_ms=ms_warm,
            visible_pairs=pairs, shape=dict(zip(
                ("B", "T", "H", "KV", "d", "window"), FLASH_MAIN)))
    del q, k, v
    torch.cuda.empty_cache()
    return row, {f"{k_}": v_ for k_, v_ in worst.items()}


# ---------------------------------------------------------------------------
# phase 6b: flash-attention backward, kernels against plain
# ---------------------------------------------------------------------------

def flash_bwd_limits(want, q, k, g: int):
    """Per-row limits on ‖got − plain‖₂ for dq (rows: queries), dk and dv
    (rows: keys), as (limit per row, e).

    Both sides compute in float32 from the same operands (lse and δ
    included) and round once to the working type.  float32: a logit is a
    d-term dot, off by at most about d·u of its terms and √d·u·L in
    practice (L = scale·max‖q‖·max‖k‖ bounds |logit|), which moves p by
    as much relative; dp likewise by d·u; a row sums up to g·S terms
    (u·√(g·S) at random signs): e = 8·u·(d + √d·L + √(g·S)) of the row's
    norm (u = 2⁻²⁴).  bfloat16 adds each side's one rounding of the row,
    2⁻⁸ of it, with margin: 4·2⁻⁸.  A floor at e of the largest row's
    norm covers rows whose terms cancel: Σ_j ds_ij = 0 exactly, so a row
    with one visible key has dq = 0 up to the rounding of dp − δ, which
    the two sides sum in other orders."""
    d, s = q.shape[-1], k.shape[1]
    lmax = float(q.float().norm(dim=-1).max() * k.float().norm(dim=-1).max()
                 ) / d ** 0.5
    e = 8 * EPS32 * (d + d ** 0.5 * lmax + (g * s) ** 0.5)
    r = 4 * EPS_BF16 if want.dtype == torch.bfloat16 else 0.0
    norm = want.float().norm(dim=-1)
    return (e + r) * norm + e * norm.max(), e


def flash_bwd_excess(got, want, q, k, g: int) -> float:
    """The largest row error over its limit."""
    limit, _ = flash_bwd_limits(want, q, k, g)
    return float(((got.float() - want.float()).norm(dim=-1) / limit).max())


# the backward's controls, the plain version made wrong on purpose:
# "dq_tile" drops the keys at positions 0-63 from dq, "dkv_tile" the
# query rows at positions 0-63 from dk and dv, "dkv_head" sums only the
# first query head of each group into dk and dv
BWD_WRONG_KINDS = ("dq_tile", "dkv_tile", "dkv_head")
BWD_TOUCHED = {"dq_tile": ("dq",), "dkv_tile": ("dk", "dv"),
               "dkv_head": ("dk", "dv")}


def wrong_bwd_parts(kind: str, q, k, v, qp, kp, dout, lse, delta, out,
                    window, causal=True) -> dict:
    """The outputs the wrong backward of ``kind`` changes, by name, from
    the plain versions (no kernel launch)."""
    from repro_torch.kernels import ref

    if kind == "dq_tile":
        return {"dq": ref.flash_bwd_dq_ref(q, k, v, qp, tile_hidden(kp, 0),
                                           dout, lse, delta, window,
                                           causal)}
    d0 = dout.clone()
    if kind == "dkv_tile":
        d0[(qp >= 0) & (qp < 64)] = 0
    else:
        g = q.shape[2] // k.shape[2]
        d0[:, :, torch.arange(q.shape[2], device=q.device) % g != 0] = 0
    dk, dv = ref.flash_bwd_dkv_ref(q, k, v, qp, kp, d0, lse,
                                   ref.flash_delta(out, d0), window, causal)
    return {"dk": dk, "dv": dv}


def wrong_bwd(kind: str):
    """A wrong ``flash_bwd`` of the kind named (it launches no kernel)."""
    from repro_torch.kernels import ref

    def fn(q, k, v, q_pos, k_pos, out, lse, dout, window, causal=True):
        delta = ref.flash_delta(out, dout)
        dq = ref.flash_bwd_dq_ref(q, k, v, q_pos, k_pos, dout, lse, delta,
                                  window, causal)
        dk, dv = ref.flash_bwd_dkv_ref(q, k, v, q_pos, k_pos, dout, lse,
                                       delta, window, causal)
        got = dict(dq=dq, dk=dk, dv=dv)
        got.update(wrong_bwd_parts(kind, q, k, v, q_pos, k_pos, dout, lse,
                                   delta, out, window, causal))
        return got["dq"], got["dk"], got["dv"]
    return fn


@contextlib.contextmanager
def flash_bwd_replaced(fn):
    """Inside, the FlashAttention Function's backward calls ``fn`` in place
    of ``flash_bwd`` (same arguments, same (dq, dk, dv) result)."""
    from repro_torch.kernels import flash_attention

    keep = flash_attention.flash_bwd
    flash_attention.flash_bwd = fn
    try:
        yield
    finally:
        flash_attention.flash_bwd = keep


def flash_bwd_inputs(dev, g, case, dtype, hide: int = 0):
    """Phase 6's inputs plus dout, with the first ``hide`` keys hidden (a
    row at T = S then sees no key), and the kernel forward's out and lse."""
    from repro_torch.kernels import flash_attention

    b, t, s, h, kv, d, causal, win = case
    q, k, v, qp, kp = flash_inputs(dev, g, b, t, s, h, kv, d, dtype)
    kp[:, :hide] = -1
    dout = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    out, lse = flash_attention.flash_fwd(q, k, v, qp, kp, win, causal)
    return q, k, v, qp, kp, dout, out, lse


def phase_flash_bwd(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(17)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_SMALL:
            b, t, s, h, kv, d, causal, win = case
            q, k, v, qp, kp, dout, out, lse = flash_bwd_inputs(
                dev, g, case, dtype, hide=3)
            delta = ref.flash_delta(out, dout)
            args = (q, k, v, qp, kp, dout, lse, delta, win, causal)
            got = (fa.flash_bwd_dq(*args),) + fa.flash_bwd_dkv(*args)
            torch.cuda.synchronize()
            want = (ref.flash_bwd_dq_ref(*args),) + ref.flash_bwd_dkv_ref(
                *args)
            w = tuple(flash_bwd_excess(a, b_, q, k, h // kv)
                      for a, b_ in zip(got, want))
            worst[(str(dtype)[6:],) + case] = w
            if not max(w) <= 1.0:
                raise AssertionError(f"flash backward {dtype} {case}: error "
                                     f"over its limit (dq, dk, dv) {w}")
    log("flash_bwd_dq / flash_bwd_dkv small cases (B, T, S, H, KV, d, "
        "causal, window; keys 0-2 hidden) in float32 and bfloat16: largest "
        "row error over its limit (dq, dk, dv)")
    for key, w in worst.items():
        log(f"  {key}: {w[0]:.3e}, {w[1]:.3e}, {w[2]:.3e}")

    b, t, h, kv, d, win = FLASH_MAIN
    case = (b, t, t, h, kv, d, True, win)
    log(f"flash backward at the scoring shape B={b} T=S={t} H={h} KV={kv} "
        f"d={d} window={win} causal bfloat16")
    q, k, v, qp, kp, dout, out, lse = flash_bwd_inputs(dev, g, case,
                                                       torch.bfloat16)
    delta = ref.flash_delta(out, dout)
    args = (q, k, v, qp, kp, dout, lse, delta, win)
    got = {"dq": fa.flash_bwd_dq(*args)}
    got["dk"], got["dv"] = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    same = torch.equal(got["dq"], fa.flash_bwd_dq(*args)) and all(
        torch.equal(a, b_) for a, b_ in zip((got["dk"], got["dv"]),
                                            fa.flash_bwd_dkv(*args)))
    log(f"  two launches of each kernel bit-equal: {same}")
    if not same:
        raise AssertionError("flash backward: two launches differ")
    want = {"dq": ref.flash_bwd_dq_ref(*args)}
    want["dk"], want["dv"] = ref.flash_bwd_dkv_ref(*args)
    over, errs = {}, {}
    for name in ("dq", "dk", "dv"):
        over[name] = flash_bwd_excess(got[name], want[name], q, k, h // kv)
        errs[name] = max_err(got[name], want[name])
    e = flash_bwd_limits(want["dq"], q, k, h // kv)[1]
    log(f"  limit per row (4·2⁻⁸ + e)·‖row‖ + e·max‖row‖, e = {e:.3e}; "
        + "; ".join(f"{n}: max_abs_err {errs[n]:.3e}, largest row error "
                    f"over its limit {over[n]:.3e}" for n in over))
    if not max(over.values()) <= 1.0:
        raise AssertionError(f"flash backward over its limit {over}")
    controls = {}
    for kind in BWD_WRONG_KINDS:
        parts = wrong_bwd_parts(kind, q, k, v, qp, kp, dout, lse, delta, out,
                                win)
        controls[kind] = {n: flash_bwd_excess(x, want[n], q, k, h // kv)
                          for n, x in parts.items()}
        log(f"  control {kind}: largest row error over the limit "
            + ", ".join(f"{n} {x:.3e}" for n, x in controls[kind].items()))
        if not min(controls[kind].values()) > 1.0:
            raise AssertionError(f"flash backward: the limits would pass "
                                 f"the wrong backward {kind}")
        del parts
    del want, got
    torch.cuda.empty_cache()

    pairs = visible_pairs(qp, kp, win, True, h)
    # each input read once, each output written once: q, dO (H heads),
    # k, v (KV heads) in bf16, lse and δ in float32; dq at H heads, dk
    # and dv at KV heads.  Operations: 6·d a visible pair for dq (q·k,
    # dO·v, ds·k), 8·d for dk and dv (q·k, dO·v, p·dO, ds·q)
    io = 2 * 2 * b * t * h * d + 2 * 2 * b * t * kv * d + 2 * 4 * b * h * t
    bounds = {"flash_bwd_dq": bound_ms(io + 2 * b * t * h * d,
                                       6 * d * pairs, BF16_FLOP_PER_S),
              "flash_bwd_dkv": bound_ms(io + 2 * 2 * b * t * kv * d,
                                        8 * d * pairs, BF16_FLOP_PER_S)}
    ms = {"flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*args), 10,
                                  cold=True),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(*args), 10,
                                   cold=True)}
    plain = {"flash_bwd_dq": time_ms(lambda: ref.flash_bwd_dq_ref(*args), 3,
                                     warmup=1),
             "flash_bwd_dkv": time_ms(lambda: ref.flash_bwd_dkv_ref(*args), 3,
                                      warmup=1)}
    lib = sdpa_backward_ms(q, k, v, qp, kp, dout, win)
    rows = {}
    for name, outs in (("flash_bwd_dq", ("dq",)),
                       ("flash_bwd_dkv", ("dk", "dv"))):
        bms, by = bounds[name]
        log(f"  {name} {ms[name]:.3f} ms cold L2 (bound {bms:.4f} ms by {by};"
            f" plain {plain[name]:.3f} ms; the backward of "
            f"scaled_dot_product_attention, dq, dk and dv together, "
            + (f"{lib:.3f} ms)" if lib is not None else "not measured)"))
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/flash_attention.py:"
                     + ("273" if name == "flash_bwd_dq" else "295"),
            max_abs_err=max(errs[o] for o in outs), ms=ms[name],
            plain_ms=plain[name], bound_ms=bms, bound_by=by,
            library_ms=lib,
            library_call="scaled_dot_product_attention with a bool mask "
                         "and enable_gqa: (forward + backward) − forward, "
                         "dq, dk and dv in one call",
            over_limit={o: over[o] for o in outs},
            controls_over_limit={kd: c for kd, c in controls.items()
                                 if set(c) & set(outs)},
            visible_pairs=pairs)
    log(f"  visible pairs {pairs:,}; bound by operations at 989 TFLOP/s "
        f"bf16: dq {6 * d * pairs / BF16_FLOP_PER_S * 1e3:.4f} ms, dk+dv "
        f"{8 * d * pairs / BF16_FLOP_PER_S * 1e3:.4f} ms")
    del q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()
    return rows, {f"{k_}": v_ for k_, v_ in worst.items()}


def sdpa_backward_ms(q, k, v, qp, kp, dout, window):
    """``scaled_dot_product_attention``'s backward with the same bool mask
    and ``enable_gqa``, timed as (forward + backward) − forward, cold L2;
    None (printed) where no backend of this PyTorch takes the call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dos = dout.transpose(1, 2).contiguous()
    dpos = qp[0][:, None] - kp[0][None, :]
    mask = (kp[0] >= 0)[None, :] & (dpos >= 0) & (dpos < window)

    def fwd():
        return sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qs, ks, vs), dos)
    try:
        both = time_ms(fwd_bwd, 10, cold=True)
        fwd_only = time_ms(fwd, 10, cold=True)
    except RuntimeError as exc:
        log(f"  scaled_dot_product_attention's backward: {exc}")
        return None
    return both - fwd_only


# ---------------------------------------------------------------------------
# phase 7: scoring at full width
# ---------------------------------------------------------------------------

def danube_params(dev):
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get("h2o-danube-1.8b")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"h2o-danube-1.8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
        f"{cfg.window}; {transformer.param_count(params):,} params in "
        f"{cfg.dtype}, seeded init on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


def device_time_by_kernel(fn):
    """Run ``fn`` once under torch.profiler: (device µs by kernel name,
    wall µs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    return {ev.key: ev.self_device_time_total for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}, wall


def phase_scoring(dev, cfg, params):
    import dataclasses
    from repro_torch.core.types import map_tree
    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
    from repro_torch.kernels import _build
    from repro_torch.models import layers, transformer

    seq = 8192
    data = SyntheticTokens(TokenPipelineConfig(cfg.vocab_size, seq, 1,
                                               seed=0)).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    layers.ATTN_IMPL = "flash"
    try:
        with torch.no_grad():
            transformer.loss_fn(params, cfg, batch)        # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            loss, fwd_s = timed(lambda: transformer.loss_fn(params, cfg,
                                                            batch))
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            times = [timed(lambda: transformer.loss_fn(params, cfg,
                                                       batch))[1]
                     for _ in range(3)]
            by_kernel, wall_us = device_time_by_kernel(
                lambda: transformer.loss_fn(params, cfg, batch))
        loss = float(loss)
        tok_s = seq / statistics.median(times)
        busy = sum(by_kernel.values())
        flash_us = sum(v for k_, v in by_kernel.items() if "flash_fwd" in k_)
        log(f"scoring: B=1 T={seq} loss {loss:.4f}; forward {fwd_s * 1e3:.1f}"
            f" ms, timed {[round(x * 1e3, 1) for x in times]} ms, "
            f"{tok_s:.1f} tokens/s (their median); peak memory "
            f"{peak / 2 ** 30:.2f} GiB; "
            f"launches {launches}")
        log(f"  profiled forward: wall {wall_us / 1e3:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms, flash_fwd {flash_us / 1e3:.1f} ms "
            f"({flash_us / busy:.3f} of the busy time)" if busy else
            "  profiled forward: device time not measured")
        for k_, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
            log(f"  {v / 1e3:10.2f} ms  {k_[:90]}")
        if launches["flash_fwd"] != cfg.n_layers:
            raise AssertionError(f"{launches['flash_fwd']} flash_fwd launches"
                                 f" in a forward, want {cfg.n_layers}")
        if not np.isfinite(loss):
            raise AssertionError(f"scoring loss {loss} is not finite")

        # 2 layers of the same width: through the flash kernel (each
        # layer's call also held against the plain version on its own
        # inputs), through two wrong attentions, and through the plain
        # attention ("xla")
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        p2 = dict(params, blocks=map_tree(lambda t: t[:2], params["blocks"]))
        calls, wrong = [], {}
        with torch.no_grad():
            with flash_replaced(recording(calls)):
                lf = transformer.forward_train(p2, cfg2, batch)
            for kind in WRONG_KINDS:
                with flash_replaced(wrong_flash(kind, cfg.window)):
                    wrong[kind] = transformer.forward_train(p2, cfg2, batch)
            layers.ATTN_IMPL = "xla"
            lx = transformer.forward_train(p2, cfg2, batch)
    finally:
        layers.ATTN_IMPL = "xla"
    per_layer = check_flash_calls(calls)
    del calls
    rel, controls = logits_check("2 layers, flash against plain", lf, lx,
                                 wrong, cfg.window)
    # the loss is printed, not checked: |Δ loss| ≤ 2·max|Δ logit| holds for
    # any logits, so the per-position logits check decides
    losses = [float(_loss(x, batch["targets"])) for x in (lf, lx)]
    log(f"  loss: flash {losses[0]:.6f}, plain {losses[1]:.6f}")
    del lf, lx, wrong
    torch.cuda.empty_cache()
    return launches, dict(loss=loss, forward_ms=fwd_s * 1e3,
                          timed_ms=[x * 1e3 for x in times],
                          tokens_per_s=tok_s, peak_gib=peak / 2 ** 30,
                          profile_wall_ms=wall_us / 1e3,
                          device_busy_ms=busy / 1e3,
                          flash_share=flash_us / busy if busy else None,
                          two_layer_flash_over_limit=per_layer,
                          two_layer_logits_rel_err=rel,
                          two_layer_controls_rel_err=controls,
                          two_layer_loss=losses)


def _loss(logits, targets):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long()).mean()


@contextlib.contextmanager
def flash_replaced(fn):
    """Inside, the model's flash attention calls ``fn`` in place of
    ``flash_fwd`` (same arguments, same (out, lse) result)."""
    from repro_torch.kernels import flash_attention

    keep = flash_attention.flash_fwd
    flash_attention.flash_fwd = fn
    try:
        yield
    finally:
        flash_attention.flash_fwd = keep


def recording(calls: list):
    """``flash_fwd`` that also keeps each call's inputs and results."""
    from repro_torch.kernels import flash_attention

    launch = flash_attention.flash_fwd

    def fn(*args):
        out, lse = launch(*args)
        calls.append((args, out, lse))
        return out, lse
    return fn


def tile_hidden(k_pos, lo: int):
    """k_pos with the keys at positions lo..lo+63 hidden (−1): what a kernel
    that skips one 64-key tile sees."""
    hide = (k_pos >= lo) & (k_pos < lo + 64)
    return torch.where(hide, torch.full_like(k_pos, -1), k_pos)


# controls: the plain version made wrong on purpose ("tile": one 64-key tile
# hidden; "gqa": query head h reads KV head h % KV, not h // (H / KV))
WRONG_KINDS = ("tile", "gqa")


def wrong_flash(kind: str, lo: int):
    """A wrong ``flash_fwd`` of the kind named (it launches no kernel)."""
    from repro_torch.kernels import ref

    def fn(q, k, v, q_pos, k_pos, window, causal=True):
        if kind == "tile":
            k_pos = tile_hidden(k_pos, lo)
        else:
            idx = torch.arange(q.shape[2], device=q.device) % k.shape[2]
            k, v = k[:, :, idx], v[:, :, idx]
        return ref.flash_fwd_ref(q, k, v, q_pos, k_pos, window, causal)
    return fn


def check_flash_calls(calls) -> list:
    """Each recorded flash_fwd call of the model against the plain version
    on the same inputs, with phase 6's limits and its dropped-tile control:
    [(largest out row error over its limit, lse over its), ...]."""
    from repro_torch.kernels import ref

    worst = []
    for i, (args, out, lse) in enumerate(calls):
        q, k, v, qp, kp, win, causal = args
        n = k.shape[1]
        want, want_lse = ref.flash_fwd_ref(*args)
        w = flash_worst(out, lse, want, want_lse, n)
        drop, drop_lse = ref.flash_fwd_ref(q, k, v, qp, tile_hidden(
            kp, max(win, 0)), win, causal)
        wd = flash_worst(drop, drop_lse, want, want_lse, n)
        log(f"  layer {i}: flash_fwd on the model's own q {tuple(q.shape)}, "
            f"k/v {tuple(k.shape)}, window {win}: out rows {w[0]:.3e} of "
            f"their limit, lse {w[1]:.3e}; a tile dropped {wd[0]:.3e}, "
            f"{wd[1]:.3e}")
        if not max(w) <= 1.0:
            raise AssertionError(f"layer {i}: flash_fwd over its limit {w}")
        # a dropped tile fails the check if either output is over its limit
        if not max(wd) > 1.0:
            raise AssertionError(f"layer {i}: the limits would pass a "
                                 "dropped tile")
        worst.append(w)
        del want, want_lse, drop, drop_lse
    return worst


# The two attention paths round p, and the plain one also each 512-key
# chunk's context, to bf16: a few 2⁻⁸ of each attention row.  This is the
# limit on the per-position logits error between them, relative to the
# row's norm.  Each comparison shows that it fails both wrong attentions.
LOGITS_REL_TOL = 8 * EPS_BF16


def rel_rows(got, want) -> float:
    """The largest ||got − want|| over ||want||, row by row (last axis)."""
    return float(((got.float() - want.float()).norm(dim=-1)
                  / want.float().norm(dim=-1)).max())


def logits_check(what: str, got, want, wrong: dict, lo: int):
    """``got`` against ``want`` within LOGITS_REL_TOL, beside the wrong
    attentions' logits; fails if the limit would pass either of them."""
    tol = LOGITS_REL_TOL
    rel = rel_rows(got, want)
    ctl = {kind: rel_rows(x, want) for kind, x in wrong.items()}
    log(f"  {what}: largest per-position logits error {rel:.3e} of the "
        f"row's norm (limit {tol:.3e}); controls: keys {lo}-{lo + 63} "
        f"hidden {ctl['tile']:.3e} ({ctl['tile'] / tol:.2f} of the limit), "
        f"query head h on KV head h % KV {ctl['gqa']:.3e} "
        f"({ctl['gqa'] / tol:.2f} of the limit)")
    if not rel <= tol:
        raise AssertionError(f"{what}: the two attention paths disagree")
    if not min(ctl.values()) > tol:
        raise AssertionError(f"{what}: the logits limit would pass a wrong "
                             f"attention {ctl}")
    return rel, ctl


# ---------------------------------------------------------------------------
# phase 8: generation at full width
# ---------------------------------------------------------------------------

def phase_generation(dev, cfg, params):
    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
    from repro_torch.kernels import _build
    from repro_torch.models import layers, transformer
    from repro_torch.serve.engine import Request, ServeEngine

    n_req, new = 8, 16
    lengths = np.random.default_rng(0).integers(256, 3001, n_req)
    lengths[0] = 3000                       # the cross-checked prompt
    rows = SyntheticTokens(TokenPipelineConfig(cfg.vocab_size, 3000, n_req,
                                               seed=1)).batch(0)["tokens"]
    eng = ServeEngine(cfg, params, n_slots=4, max_len=4096, device=dev)
    prefills, decodes, first = [], [], {}
    prefill, decode = eng.prefill, eng.decode

    def timed_prefill(p, tokens, lengths_, cache):
        out, s = timed(lambda: prefill(p, tokens, lengths_, cache))
        prefills.append((int(tokens.shape[1]), int(lengths_[0]), s * 1e3))
        first.setdefault(int(lengths_[0]), out[0][0].clone())
        return out

    def timed_decode(p, token, cache):
        out, s = timed(lambda: decode(p, token, cache))
        decodes.append(s * 1e3)
        return out
    eng.prefill, eng.decode = timed_prefill, timed_decode
    reqs = [Request(rid=i, prompt=rows[i, :n], max_tokens=new)
            for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)
    _build.reset_launches()
    _, run_s = timed(lambda: eng.run(max_ticks=1000))
    launches = dict(_build.LAUNCHES)
    generated = sum(len(r.out_tokens) for r in reqs)
    by_bucket = {}
    for bucket, _, ms in prefills:
        by_bucket.setdefault(bucket, []).append(ms)
    log(f"generation: ServeEngine 4 slots, max_len 4096; {n_req} requests, "
        f"prompts {sorted(int(x) for x in lengths)}, {new} new tokens each: "
        f"{generated} tokens in {run_s:.2f} s, {generated / run_s:.1f} "
        f"tokens/s")
    shown = {b: [round(x, 1) for x in v] for b, v in sorted(by_bucket.items())}
    log(f"  prefill ms by bucket: {shown}")
    log(f"  decode step: median {statistics.median(decodes):.2f} ms over "
        f"{len(decodes)} steps (4 slots); launches {launches} "
        f"(flash_fwd 0: prefill and decode use the plain cached attention, "
        f"as in the reference)")
    if not all(r.done and len(r.out_tokens) == new for r in reqs):
        raise AssertionError("generation: a request did not finish")
    if launches["flash_fwd"] != 0:
        raise AssertionError("generation launched the flash kernel")
    # where a decode step's time goes: one more step of the 4 slots
    tok = torch.from_numpy(eng.last_token).to(dev)
    by_kernel, wall_us = device_time_by_kernel(
        lambda: decode(params, tok, eng.cache))
    busy = sum(by_kernel.values())
    n_kern = len(by_kernel)
    log(f"  profiled decode step: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.3f} of the wall time), "
        f"{n_kern} distinct kernels")
    for k_, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]:
        log(f"  {v / 1e3:10.3f} ms  {k_[:90]}")

    # the cached prefill's first-token logits (plain attention) for the
    # 3000-token prompt against forward_train's last position through the
    # flash kernel and through the two wrong attentions (24 blocks whose
    # other operations are the same)
    prompt = {"tokens": torch.from_numpy(rows[:1, :3000]).to(dev)}
    layers.ATTN_IMPL = "flash"
    wrong = {}
    try:
        with torch.no_grad():
            full = transformer.forward_train(params, cfg, prompt)[0, -1]
            for kind in WRONG_KINDS:
                with flash_replaced(wrong_flash(kind, 1024)):
                    wrong[kind] = transformer.forward_train(
                        params, cfg, prompt)[0, -1]
    finally:
        layers.ATTN_IMPL = "xla"
    got = first[3000]
    log(f"  3000-token prompt: max_abs_err {max_err(full, got):.3e}, same "
        f"argmax: {int(torch.argmax(got)) == int(torch.argmax(full))}")
    rel, controls = logits_check(
        "engine's first-token logits against forward_train (flash) at the "
        "last position", full, got, wrong, 1024)
    return launches, dict(
        requests=n_req, prompt_lengths=[int(x) for x in lengths],
        new_tokens=new, run_s=run_s, tokens_per_s=generated / run_s,
        prefill_ms_by_bucket={str(b): v for b, v in by_bucket.items()},
        decode_ms_median=statistics.median(decodes), decode_steps=len(decodes),
        decode_profile_wall_ms=wall_us / 1e3, decode_busy_ms=busy / 1e3,
        first_token_rel_err=rel, first_token_controls_rel_err=controls)


# ---------------------------------------------------------------------------
# phase 9: the loss gradient at full width
# ---------------------------------------------------------------------------

# Limits on every leaf's ‖g_flash − g_plain‖ / ‖g_plain‖.  bfloat16: the
# flash path rounds p to bf16 in the forward only and dq, dk, dv once; the
# plain path under autograd also rounds each 512-key chunk's context, p
# and their gradients (dp, dctx) to bf16: a few 2⁻⁸ of each attention row
# and its gradient per layer, in the forward and again in the backward,
# as LOGITS_REL_TOL counts the forward's.  A leaf's gradient sums 8192
# positions of such rows, so its relative error stays of that order:
# 8·2⁻⁸.  float32 (the 2-layer cut with its weights in float32): the two
# paths compute the same float32 terms and differ only in the order of
# their sums (chunked online softmax against one pass over the keys,
# other product tilings), about √n·u of the terms for n ≤ T = 8192
# terms a sum; with a 32× margin, 32·√8192·u.
GRAD_REL_TOL = 8 * EPS_BF16
GRAD_REL_TOL_F32 = 32 * 8192 ** 0.5 * EPS32


def _flat_leaves(tree, prefix=""):
    if torch.is_tensor(tree):
        return [(prefix[:-1], tree)]
    return [x for k_, v in tree.items()
            for x in _flat_leaves(v, f"{prefix}{k_}.")]


def rel_leaves(got, want, per_layer=False) -> dict:
    """‖got − want‖ / ‖want‖ by leaf (and by layer of the stacked leaves
    when ``per_layer``), in float64."""
    out = {}
    for (name, a), (_, b) in zip(_flat_leaves(got), _flat_leaves(want)):
        pairs = [(name, a, b)]
        if per_layer and name.startswith("blocks."):
            pairs = [(f"{name}[{i}]", a[i], b[i]) for i in range(a.shape[0])]
        for n, x, y in pairs:
            out[n] = float((x.double() - y.double()).norm()
                           / y.double().norm())
    return out


def grad_norm(grads) -> float:
    return float(torch.sqrt(sum((t.float() ** 2).sum()
                                for _, t in _flat_leaves(grads))))


def phase_gradient(dev, cfg, params, scoring_loss: float):
    from repro_torch.core.types import map_tree
    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
    from repro_torch.kernels import _build
    from repro_torch.models import layers, transformer
    from repro_torch.train import trainer

    seq = 8192
    data = SyntheticTokens(TokenPipelineConfig(cfg.vocab_size, seq, 1,
                                               seed=0)).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    grads_of = lambda c, p: trainer._grads(c, p, batch)   # noqa: E731
    layers.ATTN_IMPL = "flash"
    try:
        grads_of(cfg, params)                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        (loss, g_flash), first_s = timed(lambda: grads_of(cfg, params))
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        times = [first_s] + [timed(lambda: grads_of(cfg, params))[1]
                             for _ in range(2)]
        by_kernel, wall_us = device_time_by_kernel(
            lambda: grads_of(cfg, params))
        with torch.no_grad():
            row_max = float(transformer.forward_train(
                params, cfg, batch).norm(dim=-1).max())
    finally:
        layers.ATTN_IMPL = "xla"
    loss = float(loss)
    norm = grad_norm(g_flash)
    ms = statistics.median(times) * 1e3
    busy = sum(by_kernel.values())
    share = {n: sum(v for k_, v in by_kernel.items() if n in k_) / busy
             if busy else None
             for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"gradient: trainer._grads over B=1 T={seq}, ATTN_IMPL flash, remat"
        f" per layer: loss {loss:.6f} (the scoring phase's no-grad loss "
        f"{scoring_loss:.6f}, |Δ| {abs(loss - scoring_loss):.3e}); global "
        f"grad norm {norm:.6e}; {ms:.1f} ms a gradient (median of "
        f"{[round(x * 1e3, 1) for x in times]}); peak memory "
        f"{peak / 2 ** 30:.2f} GiB; launches {launches}")
    log(f"  profiled gradient: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms; share of the busy time: "
        + ", ".join(f"{n} {v:.3f}" for n, v in share.items()) if busy else
        "  profiled gradient: device time not measured")
    for k_, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {v / 1e3:10.2f} ms  {k_[:90]}")
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{launches[name]} {name} launches in a "
                                 f"gradient, want {n}")
    if not (np.isfinite(loss) and np.isfinite(norm)):
        raise AssertionError(f"gradient: loss {loss}, norm {norm}")

    # the same gradient through the plain chunked attention under autograd
    # (same remat), held leaf by leaf
    torch.cuda.reset_peak_memory_stats()
    (loss_x, g_plain), plain_s = timed(lambda: grads_of(cfg, params))
    plain_peak = torch.cuda.max_memory_allocated()
    loss_x = float(loss_x)
    # |Δ loss| ≤ max over positions of 2·max_v |Δ logit| ≤ 2·‖Δ row‖, and
    # the scoring phase's limit holds a row to LOGITS_REL_TOL of its norm
    loss_tol = 2 * LOGITS_REL_TOL * row_max
    rel = rel_leaves(g_flash, g_plain)
    worst = max(rel, key=rel.get)
    log(f"  plain attention (\"xla\"): loss {loss_x:.6f}, |Δ| "
        f"{abs(loss - loss_x):.3e} (limit 2·{LOGITS_REL_TOL:.4f}·max‖logits "
        f"row‖ = {loss_tol:.3e}); {plain_s * 1e3:.1f} ms, peak "
        f"{plain_peak / 2 ** 30:.2f} GiB; largest leaf error "
        f"‖g_flash − g_plain‖/‖g_plain‖ {rel[worst]:.3e} ({worst}; limit "
        f"{GRAD_REL_TOL:.4f})")
    if not abs(loss - loss_x) <= loss_tol:
        raise AssertionError("gradient: the two attention paths' losses "
                             "disagree")
    if not rel[worst] <= GRAD_REL_TOL:
        raise AssertionError(f"gradient: leaf {worst} over its limit")
    del g_flash, g_plain
    torch.cuda.empty_cache()

    # 2 layers of the same width, in bf16 and with the weights in float32:
    # through the flash kernels, the plain attention and each wrong
    # backward (in both layers).  Gated: flash within the limit of its
    # type; each wrong backward outside the float32 limit on the attention
    # leaves it touches (wq for a dq fault; wk, wv for a dk/dv fault), in
    # each layer.  In bf16 the two paths' own disagreement is of the size
    # a one-tile dv fault moves wv, so there the controls are printed only.
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = dict(params, blocks=map_tree(lambda t: t[:2], params["blocks"]))
    cut = {}
    for dtype, tol in ((torch.bfloat16, GRAD_REL_TOL),
                       (torch.float32, GRAD_REL_TOL_F32)):
        rel2, controls = two_layer_grads(
            cfg2, map_tree(lambda t: t.to(dtype), p2), grads_of)
        worst2 = max(rel2, key=rel2.get)
        name = str(dtype)[6:]
        log(f"  2 layers, {name}: largest leaf error {rel2[worst2]:.3e} "
            f"({worst2}; limit {tol:.3e})")
        for kind, c in controls.items():
            log(f"  {name} control {kind}: " + ", ".join(
                f"{n} {x:.3e} ({x / tol:.1f}× the limit)"
                for n, x in c.items()))
        if not rel2[worst2] <= tol:
            raise AssertionError(f"gradient, 2 layers, {name}: {worst2} "
                                 "over the limit")
        if dtype == torch.float32 and not min(
                min(c.values()) for c in controls.values()) > tol:
            raise AssertionError("gradient: the float32 leaf limit would "
                                 "pass a wrong backward")
        cut[name] = dict(leaf_rel_err=rel2, controls_rel_err=controls,
                         limit=tol)
    torch.cuda.empty_cache()
    return launches, dict(
        loss=loss, scoring_loss=scoring_loss, grad_norm=norm, ms=ms,
        timed_ms=[x * 1e3 for x in times], peak_gib=peak / 2 ** 30,
        profile_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        kernel_share=share, plain_loss=loss_x, loss_tol=loss_tol,
        plain_ms=plain_s * 1e3, plain_peak_gib=plain_peak / 2 ** 30,
        leaf_rel_err=rel, leaf_limit=GRAD_REL_TOL, two_layers=cut)


def two_layer_grads(cfg2, p2, grads_of):
    """The 2-layer cut's gradient through the plain attention, the flash
    kernels and each wrong backward: (leaf errors of flash against plain
    by layer, {kind: errors of the leaves it touches})."""
    from repro_torch.models import layers

    _, g2x = grads_of(cfg2, p2)
    layers.ATTN_IMPL = "flash"
    try:
        _, g2f = grads_of(cfg2, p2)
        rel2 = rel_leaves(g2f, g2x, per_layer=True)
        del g2f
        controls = {}
        for kind in BWD_WRONG_KINDS:
            with flash_bwd_replaced(wrong_bwd(kind)):
                _, g = grads_of(cfg2, p2)
            r = rel_leaves(g, g2x, per_layer=True)
            weights = {"dq": "wq", "dk": "wk", "dv": "wv"}
            controls[kind] = {n: r[n] for n in (
                f"blocks.attn.{weights[o]}[{i}]"
                for o in BWD_TOUCHED[kind] for i in range(cfg2.n_layers))}
            del g
    finally:
        layers.ATTN_IMPL = "xla"
    return rel2, controls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False    # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    log(f"kernels built and loaded in {build_s:.2f} s "
        f"(nvcc {_build.build_seconds} s)\n{_build.build_log}")

    phase_s = {"build": build_s}

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        log(f"[{name}: {phase_s[name]:.2f} s]")
        return out

    warm = {}
    rows = phase("kernels", phase_kernels, dev, warm)
    main_launches, full = phase("full_width", phase_full_width, dev)
    res_launches, res = phase("resident", phase_resident, dev)
    grid_launches, resident_grid = phase("resident_grid",
                                         phase_resident_grid, dev)
    sparse_launches, sparse = phase("sparse", phase_sparse, dev)
    sparse["warm_l2_ms"] = warm
    flash_row, flash_small = phase("flash", phase_flash, dev)
    rows["flash_fwd"] = flash_row
    bwd_rows, flash_bwd_small = phase("flash_bwd", phase_flash_bwd, dev)
    rows.update(bwd_rows)
    cfg, params = phase("danube_params", danube_params, dev)
    score_launches, scoring = phase("scoring", phase_scoring, dev, cfg,
                                    params)
    gen_launches, generation = phase("generation", phase_generation, dev,
                                     cfg, params)
    grad_launches, gradient = phase("gradient", phase_gradient, dev, cfg,
                                    params, scoring["loss"])
    del params
    rows["flash_fwd"]["launches"] = score_launches["flash_fwd"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[name]["launches"] = grad_launches[name]
    rows["matvec2"]["launches"] = main_launches["matvec2"]
    rows["rank2_apply"]["launches"] = main_launches["rank2_apply"]
    rows["figmn_stream"]["launches"] = res_launches["figmn_stream"]
    rows["figmn_stream_grid"]["launches"] = \
        grid_launches["figmn_stream_grid"]
    # mahalanobis has no runtime caller (nor has the reference's kernel):
    # its count from the sparse run is 0
    for name in ("gathered_matvec", "scatter_apply", "mahalanobis"):
        rows[name]["launches"] = sparse_launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k_: r[k_] for k_ in keys}
                                  for r in rows.values()],
                      "full_width": full, "resident": res,
                      "resident_grid": resident_grid,
                      "figmn_stream_grid": {k_: rows["figmn_stream_grid"][k_]
                                            for k_ in ("plan", "g3_small_ms",
                                                       "barriers_per_launch")},
                      "sparse": sparse, "flash_small": flash_small,
                      "flash": {k_: flash_row[k_] for k_ in (
                          "warm_l2_ms", "visible_pairs", "library_call",
                          "library_expanded_kv_ms", "shape")},
                      "flash_bwd_small": flash_bwd_small,
                      "flash_bwd": {n: {k_: bwd_rows[n][k_] for k_ in (
                          "over_limit", "controls_over_limit",
                          "library_call", "visible_pairs")}
                          for n in bwd_rows},
                      "scoring": scoring, "generation": generation,
                      "generation_launches": gen_launches,
                      "gradient": gradient, "gradient_launches": grad_launches,
                      "build_s": build_s, "phase_s": phase_s,
                      "script_s": time.perf_counter() - T_START}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
