"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  A CUDA kernel has no CPU mode, so without a card every test here
skips.  This file imports neither JAX nor the reference package, so it runs
on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: a matvec's two summation orders differ by at most 2·D·u·Σ|terms|
(u = 2⁻²⁴); rank2_apply rounds exactly as its plain version (same
association, no multiply-add contraction), so 4 ulps of the largest entry;
the resident kernels over a chunk (one block, and the grid at a forced
G ≥ 3) use tests/test_figmn_stream_kernel.py's tolerances (1e-3).  gathered_matvec is a matvec (the same bound);
mahalanobis nests two such sums (γ_D on each, on precision-like Λ);
scatter_apply equals its plain version bit for bit and leaves the K − C
other rows bit-equal.  flash_fwd: per row, ‖out − plain‖₂ within
4·2⁻⁸·‖row‖ in bf16 (p and out rounded on each side) and 8·u·√S·‖row‖ in
float32, lse within 2·(S + 4)·u + 4u·|lse| (chip_smoke.py's limits).
flash_bwd_dq / flash_bwd_dkv: per row, chip_smoke.py's backward limit
(``flash_bwd_excess``); two launches bit-equal; remat ≡ no remat bit for
bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import figmn, shortlist
from repro_torch.core.types import FIGMNConfig, gate_threshold
from repro_torch.kernels import (_build, figmn_sparse, figmn_stream,
                                 figmn_update, flash_attention, mahalanobis,
                                 ref)
from repro_torch.models import layers, transformer

EPS32 = 2.0 ** -24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,d", [(4, 5), (8, 130), (64, 794)])
def test_update_kernels_match_plain(cuda, k, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    lam = torch.randn((k, d, d), generator=g, device=cuda)
    a = torch.randn((k, d), generator=g, device=cuda)
    b = torch.randn((k, d), generator=g, device=cuda)
    w = torch.rand((k,), generator=g, device=cuda) * 0.5
    before = _build.LAUNCHES["matvec2"]
    y, z = figmn_update.matvec2(lam, a, b)
    assert _build.LAUNCHES["matvec2"] == before + 1
    tol = 2 * d * EPS32 * float(torch.einsum(
        "kde,ke->kd", lam.abs(), torch.maximum(a.abs(), b.abs())).max())
    assert float((y - ref.matvec_ref(lam, a)).abs().max()) <= tol
    assert float((z - ref.matvec_ref(lam, b)).abs().max()) <= tol
    for yb, c2 in ((None, None), (b, 0.5 * w)):
        want = ref.rank2_apply_ref(lam, a, yb, 1.0 / (1.0 - w), w, c2)
        got = figmn_update.rank2_apply(lam, a, yb, 1.0 / (1.0 - w), w, c2)
        assert float((got - want).abs().max()) \
            <= 4 * EPS32 * float(want.abs().max())
    inplace = lam.clone()
    figmn_update.rank2_apply(inplace, a, None, 1.0 / (1.0 - w), w, None,
                             out=inplace)
    assert torch.equal(inplace, figmn_update.rank2_apply(
        lam, a, None, 1.0 / (1.0 - w), w, None))


@pytest.mark.cuda
@pytest.mark.parametrize("k,d", [(4, 8), (16, 32)])
def test_stream_kernel_matches_plain(cuda, k, d):
    rng = np.random.default_rng(d)
    centers = rng.normal(0, 6.0, (3, d))
    x = (centers[rng.integers(0, 3, 400)]
         + rng.normal(0, 1.0, (400, d))).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    cfg = FIGMNConfig(kmax=k, dim=d, beta=0.1, delta=1.0, vmin=1e9,
                      spmin=0.0, update_mode="exact",
                      sigma_ini=figmn.sigma_from_data(xt, 1.0))
    st = figmn.fit(cfg, figmn.init_state(cfg, cuda), xt[:150])
    args = (xt[150:].contiguous(), st.mu, st.lam, st.logdet, st.sp,
            st.active.to(torch.int32), gate_threshold(cfg), d)
    got = figmn_stream.figmn_stream(*args)
    want = ref.figmn_stream_ref(*args)
    assert int(got[4][0]) == int(want[4][0]) > 0
    m = st.active
    for g_, w_ in zip(got[:4], want[:4]):
        torch.testing.assert_close(g_[m], w_[m], rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_stream_kernel_refuses_a_pool_beyond_shared_memory(cuda):
    """A pool beyond one block goes to the grid; one beyond the grid's
    capacity (32 MiB of Λ: more than the card's co-resident blocks hold)
    raises instead of falling back."""
    k, d = 128, 256
    assert figmn_stream.smem_bytes(k, d) > _build.smem_optin(cuda)
    z = torch.zeros((k, d), device=cuda)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="co-resident"):
        figmn_stream.figmn_stream(
            torch.zeros((4, d), device=cuda), z,
            torch.zeros((k, d, d), device=cuda), z[:, 0].contiguous(),
            z[:, 0].contiguous(), torch.zeros(k, dtype=torch.int32,
                                              device=cuda), 1.0, d)
    assert _build.LAUNCHES == before


def _formed_stream_args(cuda, k, d, n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 6.0, (3, d))
    x = (centers[rng.integers(0, 3, 150 + n)]
         + rng.normal(0, 1.0, (150 + n, d))).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    cfg = FIGMNConfig(kmax=k, dim=d, beta=0.1, delta=1.0, vmin=1e9,
                      spmin=0.0, update_mode="exact",
                      sigma_ini=figmn.sigma_from_data(xt, 1.0))
    st = figmn.fit(cfg, figmn.init_state(cfg, cuda), xt[:150])
    return st, (xt[150:].contiguous(), st.mu, st.lam, st.logdet, st.sp,
                st.active.to(torch.int32), gate_threshold(cfg), d)


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,blocks,n", [(4, 8, 3, 250), (16, 32, 3, 250),
                                          (16, 32, 7, 250), (5, 37, 4, 250),
                                          (16, 32, 5, 1)])
def test_stream_grid_kernel_matches_plain(cuda, k, d, blocks, n):
    """The grid kernel at a forced G ≥ 3 (rows straddle components; D = 37
    is ragged): the accepts equal, the state within the one-block kernel's
    tolerances of the plain version, two launches bit-equal."""
    st, args = _formed_stream_args(cuda, k, d, n, seed=d + blocks)
    plan = figmn_stream.grid_plan(k, d, _build.smem_optin(cuda),
                                  figmn_stream.grid_capacity(
                                      cuda, _build.smem_optin(cuda)),
                                  blocks=blocks)
    assert plan.blocks == blocks
    assert _build.lib().figmn_stream_grid_smem_bytes(
        plan.rows, plan.nc, d) == plan.smem_bytes
    before = _build.LAUNCHES["figmn_stream_grid"]
    got = figmn_stream.figmn_stream(*args, plan=plan)
    again = figmn_stream.figmn_stream(*args, plan=plan)
    assert _build.LAUNCHES["figmn_stream_grid"] == before + 2
    want = ref.figmn_stream_ref(*args)
    assert int(got[4][0]) == int(want[4][0]) > 0
    m = st.active
    for g_, w_ in zip(got[:4], want[:4]):
        torch.testing.assert_close(g_[m], w_[m], rtol=1e-3, atol=1e-3)
    for g_, a_ in zip(got, again):
        assert torch.equal(g_, a_)


@pytest.mark.cuda
def test_runtime_runs_a_pool_beyond_one_block_on_the_grid(cuda):
    """(K = 32, D = 64): "auto" resolves to "vmem", and the chunks after
    the first run the grid kernel."""
    from repro_torch.stream import (LifecycleConfig, RuntimeConfig,
                                    StreamRuntime)
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 6.0, (8, 64))
    x = (centers[rng.integers(0, 8, 512)]
         + rng.normal(0, 1.0, (512, 64))).astype(np.float32)
    cfg = FIGMNConfig(kmax=32, dim=64, beta=0.1, delta=1.0, vmin=50.0,
                      spmin=1.0, update_mode="exact",
                      sigma_ini=figmn.sigma_from_data(torch.from_numpy(x),
                                                      1.0).numpy())
    rt = StreamRuntime(cfg, RuntimeConfig(
        chunk=128, device="cuda",
        lifecycle=LifecycleConfig(k_budget=32, every=8)))
    assert rt.path == "vmem"
    before = _build.LAUNCHES["figmn_stream_grid"]
    summary = rt.ingest(x)
    assert _build.LAUNCHES["figmn_stream_grid"] == before + 3
    assert summary["accepted"] > 0 and summary["active_k"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path,blocks", [("scan", None), ("vmem", None),
                                         ("vmem", 3)])
def test_runtime_lifecycle_prunes_and_merges_on_the_card(cuda, monkeypatch,
                                                         path, blocks):
    """The lifecycle's prune, spawn and merge on CUDA tensors: a budget
    below the stream's 6 modes, spmin > 0 and isolated outliers that make
    short-lived slots.  The card's runtime (the kernels; ``blocks`` forces
    the grid) against the same runtime on the CPU (plain versions, held
    against the reference in tests/test_torch_lifecycle.py): every count
    equal, the state within the resident kernels' 1e-3."""
    from repro_torch.stream import (LifecycleConfig, RuntimeConfig,
                                    StreamRuntime)
    rng = np.random.default_rng(4)
    centers = rng.normal(0, 6.0, (6, 6))
    x = centers[rng.integers(0, 6, 256)] + rng.normal(0, 1.0, (256, 6))
    x[::16] = rng.normal(0, 30.0, (16, 6))
    x = x.astype(np.float32)
    cfg = FIGMNConfig(kmax=8, dim=6, beta=0.1, delta=1.0, vmin=20.0,
                      spmin=3.0, update_mode="exact", backend="pallas",
                      sigma_ini=figmn.sigma_from_data(torch.from_numpy(x),
                                                      1.0).numpy())
    rc = RuntimeConfig(chunk=32, path=path, device="cpu",
                       lifecycle=LifecycleConfig(k_budget=3, every=2,
                                                 spawn_max=4))
    cpu = StreamRuntime(cfg, rc)
    want = cpu.ingest(x)
    if blocks:
        smem = _build.smem_optin(cuda)
        cap = figmn_stream.grid_capacity(cuda, smem)
        monkeypatch.setattr(
            figmn_stream, "resident_plan",
            lambda k, d, device, *_: figmn_stream.grid_plan(
                k, d, smem, cap, blocks=blocks))
    before = dict(_build.LAUNCHES)
    rt = StreamRuntime(cfg, dataclasses.replace(rc, device="cuda"))
    got = rt.ingest(x)
    launched = {k_: _build.LAUNCHES[k_] - before[k_] for k_ in before}
    assert launched["rank2_apply"] > 0                # the spawn replay
    if path == "vmem":
        kernel = "figmn_stream_grid" if blocks else "figmn_stream"
        assert launched[kernel] == sum(m.path == "vmem"
                                       for m in rt.telemetry.history) > 0
        assert got["spawned"] > 0 and got["accepted"] > 0
    assert got["pruned"] > 0 and got["merged"] > 0
    for key in ("chunks", "total_points", "active_k", "created", "pruned",
                "merged", "spawned", "accepted"):
        assert got[key] == want[key], key
    assert [(m.path, m.pruned, m.merged, m.spawned, m.active_k)
            for m in rt.telemetry.history] \
        == [(m.path, m.pruned, m.merged, m.spawned, m.active_k)
            for m in cpu.telemetry.history]
    m = cpu.state.active
    assert torch.equal(rt.state.active.cpu(), m)
    for f in ("mu", "lam", "logdet", "sp", "v"):
        torch.testing.assert_close(getattr(rt.state, f).cpu()[m],
                                   getattr(cpu.state, f)[m],
                                   rtol=1e-3, atol=1e-3, msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,c", [(10, 6, 3), (16, 130, 512), (64, 794, 8)])
def test_sparse_kernels_match_plain(cuda, k, d, c):
    """c = 512 pairs with repeats stands for the read path's flattened
    (point, slot) pairs; the scatter takes unique indices only."""
    g = torch.Generator(device=cuda).manual_seed(d + c)
    lam = torch.randn((k, d, d), generator=g, device=cuda)
    diff = torch.randn((c, d), generator=g, device=cuda)
    idx = torch.randint(0, k, (c,), generator=g, device=cuda,
                        dtype=torch.int32)
    before = _build.LAUNCHES["gathered_matvec"]
    y = figmn_sparse.gathered_matvec(lam, diff, idx)
    assert _build.LAUNCHES["gathered_matvec"] == before + 1
    tol = 2 * d * EPS32 * float(torch.einsum(
        "kde,ke->kd", lam[idx.long()].abs(), diff.abs()).max())
    assert float((y - ref.gathered_matvec_ref(lam, diff, idx))
                 .abs().max()) <= tol
    cu = min(c, k)
    uidx = torch.randperm(k, generator=g, device=cuda)[:cu].to(torch.int32)
    coefs = torch.rand((cu, 2), generator=g, device=cuda) + 0.5
    got = figmn_sparse.scatter_apply(lam.clone(), y[:cu].contiguous(), coefs,
                                     uidx)
    want = ref.scatter_apply_ref(lam.clone(), y[:cu], coefs, uidx)
    assert torch.equal(got, want)
    rest = torch.ones(k, dtype=torch.bool, device=cuda)
    rest[uidx.long()] = False
    assert torch.equal(got[rest], lam[rest])


def _precision(k, d, g, device):
    """Precision matrices as the learner keeps them: positive diagonal
    plus a low-rank PSD part, so d² carries the sum and a dropped row of
    Λ shows above the rounding bound."""
    q = torch.randn((k, d, 8), generator=g, device=device) / d ** 0.5
    u = 0.5 + torch.rand((k, d), generator=g, device=device)
    return torch.diag_embed(u) + q @ q.transpose(1, 2)


def mahalanobis_tol(diff, lam):
    """(K,) bound on |kernel − plain| for d² = Σ_r diff_r·(Λ_r·diff): each
    inner sum errs by at most γ_D·Σ_c|Λ_rc||diff_c|, the outer by γ_D·
    Σ_r|diff_r·s_r|; two orders differ by at most twice the sum."""
    d = diff.shape[1]
    gamma = (d + 1) * EPS32 / (1 - (d + 1) * EPS32)
    inner = torch.einsum("kd,kde,ke->k", diff.abs(), lam.abs(), diff.abs())
    s = torch.einsum("kde,ke->kd", lam, diff)
    return 2 * gamma * (inner + (diff * s).abs().sum(dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("k,d", [(4, 5), (8, 130), (64, 794)])
def test_mahalanobis_kernel_matches_plain_and_repeats(cuda, k, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    lam = _precision(k, d, g, cuda)
    diff = torch.randn((k, d), generator=g, device=cuda)
    got = mahalanobis.mahalanobis(diff, lam)
    tol = mahalanobis_tol(diff, lam)
    want = ref.mahalanobis_ref(diff, lam)
    assert bool(((got - want).abs() <= tol).all())
    # the bound is tight enough that dropping a row of mean weight (d²/D)
    # from any Λ_k, let alone a warp's share of rows, would break it
    assert bool((tol < want / d).all())
    assert torch.equal(got, mahalanobis.mahalanobis(diff, lam))


@pytest.mark.cuda
def test_shortlisted_reads_refuse_float64_on_the_card(cuda):
    """On the card the shortlisted reads always take the float32 kernel:
    a float64 state raises, as on the write path, and never falls back
    to building the (B, C, D, D) gather."""
    k, d, c = 6, 8, 2
    g = torch.Generator(device=cuda).manual_seed(1)
    lam = _precision(k, d, g, cuda).double()
    diff = torch.randn((4, c, d), generator=g, device=cuda,
                       dtype=torch.float64)
    idx = torch.randint(0, k, (4, c), generator=g, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        shortlist.gathered_products(lam, diff, idx)


@pytest.mark.cuda
def test_fit_sparse_on_the_card(cuda):
    """The kernel backend against the plain backend, and no host sync
    inside ``fit_sparse``."""
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 6.0, (4, 24))
    x = torch.from_numpy((centers[rng.integers(0, 4, 300)]
                          + rng.normal(0, 1.0, (300, 24))).astype(np.float32)
                         ).to(cuda)
    cfg = FIGMNConfig(kmax=12, dim=24, beta=0.1, delta=1.0, vmin=1e9,
                      spmin=0.0, update_mode="exact", backend="pallas",
                      shortlist_c=3, sigma_ini=figmn.sigma_from_data(x, 1.0))
    state = figmn.init_state(cfg, cuda)       # (reads log|C| on the host)
    before = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = shortlist.fit_sparse(cfg, state, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.LAUNCHES["gathered_matvec"] == before["gathered_matvec"] \
        + 300
    assert _build.LAUNCHES["scatter_apply"] == before["scatter_apply"] + 300
    want = shortlist.fit_sparse(dataclasses.replace(cfg, backend="jnp"),
                                figmn.init_state(cfg, cuda), x)
    assert int(got.n_created) == int(want.n_created)
    m = want.active
    torch.testing.assert_close(got.lam[m], want.lam[m], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got.mu[m], want.mu[m], rtol=1e-4, atol=1e-4)


FLASH_CASES = [
    # (B, T, S, H, KV, d, causal, window)
    (2, 32, 32, 2, 2, 16, True, 0),
    (1, 33, 65, 2, 1, 64, False, 0),
    (1, 100, 300, 4, 2, 80, True, 37),
    (1, 70, 70, 2, 2, 128, True, 0),
    (1, 65, 130, 2, 2, 256, False, 20),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, t, s, h, kv, d, causal, win = case
    g = torch.Generator(device=cuda).manual_seed(d + t)
    q = torch.randn((b, t, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, kv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, kv, d), generator=g, device=cuda).to(dtype)
    qp = torch.arange(s - t, s, dtype=torch.int32,
                      device=cuda)[None].expand(b, t).contiguous()
    kp = torch.arange(s, dtype=torch.int32,
                      device=cuda)[None].expand(b, s).contiguous()
    kp[:, :3] = -1                            # hidden slots
    before = _build.LAUNCHES["flash_fwd"]
    out, lse = flash_attention.flash_fwd(q, k, v, qp, kp, win, causal)
    assert _build.LAUNCHES["flash_fwd"] == before + 1
    want, want_lse = ref.flash_fwd_ref(q, k, v, qp, kp, win, causal)
    norm = want.float().norm(dim=-1)
    row = 4 * 2.0 ** -8 * norm if dtype == torch.bfloat16 \
        else 8 * EPS32 * s ** 0.5 * norm
    assert bool(((out.float() - want.float()).norm(dim=-1) <= row).all())
    lse_tol = 2 * (s + 4) * EPS32 + 4 * EPS32 * float(want_lse.abs().max())
    assert float((lse - want_lse).abs().max()) <= lse_tol
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())


@pytest.mark.cuda
def test_flash_path_launches_once_per_layer(cuda):
    """ATTN_IMPL = "flash" with CUDA tensors: one flash_fwd launch per
    layer of a forward, none with the plain attention."""
    from repro_torch import configs
    cfg = configs.get_smoke("h2o-danube-1.8b")
    params = transformer.init_params(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                         dtype=torch.int32)
    before = _build.LAUNCHES["flash_fwd"]
    try:
        layers.ATTN_IMPL = "flash"
        with torch.no_grad():
            a = transformer.forward_train(params, cfg, {"tokens": toks})
    finally:
        layers.ATTN_IMPL = "xla"
    assert _build.LAUNCHES["flash_fwd"] == before + cfg.n_layers
    with torch.no_grad():
        b = transformer.forward_train(params, cfg, {"tokens": toks})
    assert _build.LAUNCHES["flash_fwd"] == before + cfg.n_layers
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_refuses_float64_on_the_card(cuda):
    q = torch.zeros((1, 4, 2, 16), dtype=torch.float64, device=cuda)
    pos = torch.arange(4, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_fwd(q, q, q, pos, pos, 0)


# flash backward: (B, T, S, H, KV, d, causal, window); the first three keys
# are hidden, so with T = S the first rows see no key
FLASH_BWD_CASES = [
    (2, 32, 32, 2, 2, 16, True, 0),
    (1, 33, 65, 2, 1, 64, False, 0),
    (1, 100, 300, 4, 2, 80, True, 37),
    (1, 70, 70, 2, 2, 128, True, 0),
    (1, 130, 129, 6, 2, 80, True, 0),
]


def flash_bwd_excess(got, want, q, k, g, dtype) -> float:
    """The largest per-row ‖got − want‖ over chip_smoke.py's limit:
    (e + r)·‖want_i‖ + e·max‖want‖, e = 8·u·(d + √d·L + √(g·S)) for the
    float32 sums (L = scale·max‖q‖·max‖k‖ bounds a logit), r = 4·2⁻⁸ for
    the one bf16 rounding on each side."""
    d, s = q.shape[-1], k.shape[1]
    lmax = float(q.float().norm(dim=-1).max() * k.float().norm(dim=-1).max()
                 ) / d ** 0.5
    e = 8 * EPS32 * (d + d ** 0.5 * lmax + (g * s) ** 0.5)
    r = 4 * 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    norm = want.float().norm(dim=-1)
    limit = (e + r) * norm + e * norm.max()
    return float(((got.float() - want.float()).norm(dim=-1) / limit).max())


def _flash_bwd_inputs(cuda, case, dtype):
    b, t, s, h, kv, d, causal, win = case
    g = torch.Generator(device=cuda).manual_seed(d + t + s)
    q, k, v, dout = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                     for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d),
                                   (b, t, h, d)))
    qp = torch.arange(s - t, s, dtype=torch.int32,
                      device=cuda)[None].expand(b, t).contiguous()
    kp = torch.arange(s, dtype=torch.int32,
                      device=cuda)[None].expand(b, s).contiguous()
    kp[:, :3] = -1
    out, lse = ref.flash_fwd_ref(q, k, v, qp, kp, win, causal)
    return q, k, v, qp, kp, out, lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda, case, dtype):
    b, t, s, h, kv, d, causal, win = case
    q, k, v, qp, kp, out, lse, dout = _flash_bwd_inputs(cuda, case, dtype)
    delta = ref.flash_delta(out, dout)
    args = (q, k, v, qp, kp, dout, lse, delta, win, causal)
    before = dict(_build.LAUNCHES)
    dq = flash_attention.flash_bwd_dq(*args)
    dk, dv = flash_attention.flash_bwd_dkv(*args)
    assert _build.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert _build.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = (ref.flash_bwd_dq_ref(*args),) + ref.flash_bwd_dkv_ref(*args)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype, name
        assert flash_bwd_excess(got, w, q, k, h // kv, dtype) <= 1.0, name
    if t == s:                       # rows that see no key get dq = 0
        assert bool((dq[:, :3] == 0).all())
    # deterministic: a second launch is bit-equal (no atomics)
    assert torch.equal(dq, flash_attention.flash_bwd_dq(*args))
    for a, b_ in zip((dk, dv), flash_attention.flash_bwd_dkv(*args)):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_flash_attention_output_carries_the_gradient(cuda):
    """CUDA tensors that require grad: the kernel's output has a grad_fn,
    and its backward launches one flash_bwd_dq and one flash_bwd_dkv and
    gives the plain backward's gradients."""
    case = FLASH_BWD_CASES[2]
    b, t, s, h, kv, d, causal, win = case
    q, k, v, qp, kp, out, lse, dout = _flash_bwd_inputs(cuda, case,
                                                        torch.float32)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(_build.LAUNCHES)
    got = flash_attention.flash_attention(*leaves, qp, kp, win,
                                          causal=causal)
    assert got.grad_fn is not None
    got.backward(dout)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] == before[name] + 1, name
    want = ref.flash_bwd_ref(q, k, v, qp, kp, out, lse, dout, win, causal)
    for x, w in zip(leaves, want):
        assert flash_bwd_excess(x.grad, w, q, k, h // kv,
                                torch.float32) <= 1.0


@pytest.mark.cuda
def test_remat_equals_no_remat_on_the_card(cuda, monkeypatch):
    """danube-smoke on the card with "flash": per-layer remat runs the
    forward kernel twice a layer and changes no bit of the loss or the
    gradient (the kernels are deterministic)."""
    import functools

    from repro_torch import configs
    from repro_torch.train import trainer
    cfg = configs.get_smoke("h2o-danube-1.8b")
    params = transformer.init_params(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                         dtype=torch.int32)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    monkeypatch.setattr(layers, "ATTN_IMPL", "flash")
    runs = []
    for remat in (True, False):
        with monkeypatch.context() as m:
            m.setattr(transformer, "_scan_blocks", functools.partial(
                transformer._scan_blocks, remat=remat))
            _build.reset_launches()
            loss, grads = trainer._grads(cfg, params, batch)
            runs.append((loss, grads, dict(_build.LAUNCHES)))
    (l1, g1, n1), (l0, g0, n0) = runs
    layers_ = cfg.n_layers
    assert n1["flash_fwd"] == 2 * layers_ and n0["flash_fwd"] == layers_
    for n in (n1, n0):
        assert n["flash_bwd_dq"] == n["flash_bwd_dkv"] == layers_
    assert torch.equal(l1, l0)
    for a, b_ in zip(_leaves(g1), _leaves(g0)):
        assert torch.equal(a, b_)
    assert all(bool(torch.isfinite(a).all()) for a in _leaves(g1))


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    return [x for v in tree.values() for x in _leaves(v)]


@pytest.mark.cuda
def test_flash_bwd_refuses_a_head_dim_beyond_shared_memory(cuda):
    q = torch.zeros((1, 4, 2, 256), device=cuda)
    pos = torch.arange(4, dtype=torch.int32, device=cuda)[None]
    lse = torch.zeros((1, 2, 4), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention.flash_bwd_dkv(q, q, q, pos, pos, q, lse, lse, 0)
