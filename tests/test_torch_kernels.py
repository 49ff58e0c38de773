"""The port's kernel modules (``repro_torch.kernels``) against the JAX
reference.

On the CPU every wrapper takes its plain PyTorch version, so these tests
hold the plain versions against the Pallas kernels in interpret mode (run
as tests/test_kernels.py and tests/test_figmn_stream_kernel.py run them)
and against ``repro.kernels.ref``, and the ``ops`` wrappers against
``repro.kernels.ops`` at a D that is not a multiple of 128.  The CUDA
kernels themselves run only on a card: tests/test_torch_cuda.py holds each
against its plain version there.

Tolerances: float32 throughout.  Matvecs and quadratic forms sum D products
in another order than XLA (rtol 2e-5, atol 2e-4·D, as tests/test_kernels.py
uses for the Pallas kernels); elementwise passes round identically except
where a product feeds a difference (rtol 1e-6 / atol 1e-6 of the scale).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import figmn as jfigmn
from repro.core.types import FIGMNConfig as JConfig
from repro.core.types import chi2_quantile as jchi2
from repro.kernels import figmn_stream as jstream
from repro.kernels import figmn_update as jupdate
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import figmn
from repro_torch.core.types import FIGMNConfig, gate_threshold
from repro_torch.kernels import (_build, figmn_sparse, figmn_stream,
                                 figmn_update, mahalanobis, ops, ref)

SHAPES = [(1, 4), (4, 5), (3, 130), (2, 257)]


def _psd(rng, k, d):
    a = rng.normal(0, 1, (k, d, d)).astype(np.float32)
    return (np.einsum("kde,kfe->kdf", a, a)
            + np.eye(d, dtype=np.float32) * d).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pad(a, dpad):
    out = np.zeros(a.shape[:-2] + (dpad, dpad) if a.ndim == 3
                   else a.shape[:-1] + (dpad,), np.float32)
    if a.ndim == 3:
        out[:, :a.shape[1], :a.shape[2]] = a
    else:
        out[:, :a.shape[1]] = a
    return out


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("k,d", [(1, 4), (4, 5), (3, 130), (2, 256)])
def test_matvec2_plain_matches_pallas_interpret(k, d):
    rng = np.random.default_rng(d)
    lam = _psd(rng, k, d)
    e = rng.normal(0, 1, (k, d)).astype(np.float32)
    m = rng.normal(0, 0.1, (k, d)).astype(np.float32)
    dpad = max(128, -(-d // 128) * 128)
    y, z = jupdate.matvec2_pallas(jnp.asarray(_pad(lam, dpad)),
                                  jnp.asarray(_pad(e, dpad)),
                                  jnp.asarray(_pad(m, dpad)),
                                  block_d=128, interpret=True)
    ty, tz = figmn_update.matvec2(_t(lam), _t(e), _t(m))
    _close(ty, np.asarray(y)[:, :d], 2e-5, 2e-4 * d)
    _close(tz, np.asarray(z)[:, :d], 2e-5, 2e-4 * d)
    # the one-vector variant gives the same y
    ty1, tz1 = figmn_update.matvec2(_t(lam), _t(e))
    assert tz1 is None and torch.equal(ty1, ty)


@pytest.mark.parametrize("k,d", [(1, 4), (4, 5), (3, 130), (2, 256)])
@pytest.mark.parametrize("two", [True, False])
def test_rank2_apply_plain_matches_pallas_interpret(k, d, two):
    rng = np.random.default_rng(d * 3 + two)
    lam = _psd(rng, k, d)
    y = rng.normal(0, 1, (k, d)).astype(np.float32)
    yb = rng.normal(0, 1, (k, d)).astype(np.float32) if two \
        else np.zeros((k, d), np.float32)
    inv1mw = rng.uniform(1.0, 2.0, k).astype(np.float32)
    c1 = rng.uniform(-0.5, 0.5, k).astype(np.float32)
    c2 = rng.uniform(-0.5, 0.5, k).astype(np.float32) if two \
        else np.zeros(k, np.float32)
    dpad = max(128, -(-d // 128) * 128)
    want = jupdate.rank2_apply_pallas(
        jnp.asarray(_pad(lam, dpad)), jnp.asarray(_pad(y, dpad)),
        jnp.asarray(_pad(yb, dpad)), jnp.asarray(inv1mw), jnp.asarray(c1),
        jnp.asarray(c2), block_r=128, block_c=128, interpret=True)
    got = figmn_update.rank2_apply(
        _t(lam), _t(y), _t(yb) if two else None, _t(inv1mw), _t(c1),
        _t(c2) if two else None)
    # same association as the Pallas body, elementwise: equal up to XLA's
    # own fusion of the multiply-adds
    scale = float(np.abs(lam).max())
    _close(got, np.asarray(want)[:, :d, :d], 1e-6, 1e-6 * scale)


def _formed_mixture(seed=0, d=8, k=4):
    """tests/test_figmn_stream_kernel.py's fixture: a mixture formed by the
    reference scan over three seeded clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 6, (3, d))
    x0 = np.concatenate([rng.normal(c, 1.0, (30, d)) for c in centers])
    cfg = JConfig(kmax=k, dim=d, beta=0.05, delta=1.0, vmin=1e9, spmin=0.0,
                  update_mode="exact",
                  sigma_ini=jfigmn.sigma_from_data(
                      jnp.asarray(x0, jnp.float32), 1.0))
    state = jfigmn.fit(cfg, jfigmn.init_state(cfg),
                       jnp.asarray(x0, jnp.float32))
    xs = np.concatenate([rng.normal(c, 0.8, (14, d)) for c in centers])
    return cfg, state, xs.astype(np.float32)


@pytest.mark.parametrize("d,n", [(8, 40), (16, 42)])
def test_figmn_stream_plain_matches_pallas_interpret(d, n):
    cfg, state, xs = _formed_mixture(d=d)
    xs = xs[:n]
    thresh = float(jchi2(d, 1.0 - cfg.beta))
    s = {f: np.array(getattr(state, f)) for f in ("mu", "lam", "logdet",
                                                   "sp", "active")}
    got = figmn_stream.figmn_stream(
        _t(xs), _t(s["mu"]), _t(s["lam"]), _t(s["logdet"]), _t(s["sp"]),
        torch.from_numpy(s["active"].astype(np.int32)), thresh, d)
    # the Pallas wrapper donates its state inputs
    want = jstream.figmn_stream_pallas(
        jnp.asarray(xs), jnp.asarray(s["mu"]), jnp.asarray(s["lam"]),
        jnp.asarray(s["logdet"]), jnp.asarray(s["sp"]),
        jnp.asarray(s["active"].astype(np.int32)),
        jnp.asarray([thresh], jnp.float32), dim=d, n_points=n,
        interpret=True)
    assert int(got[4][0]) == int(want[4][0])
    m = s["active"]
    # tolerances of tests/test_figmn_stream_kernel.py (n sequential points)
    _close(got[0].numpy()[m], np.asarray(want[0])[m], 0, 2e-4)
    _close(got[1].numpy()[m], np.asarray(want[1])[m], 1e-3, 1e-3)
    _close(got[2].numpy()[m], np.asarray(want[2])[m], 0, 1e-3)
    _close(got[3].numpy()[m], np.asarray(want[3])[m], 0, 1e-3)


@pytest.mark.parametrize("k,d", SHAPES)
def test_plain_versions_match_reference_ref(k, d):
    rng = np.random.default_rng(k * 1000 + d)
    lam = _psd(rng, k, d)
    e = rng.normal(0, 1, (k, d)).astype(np.float32)
    m = rng.normal(0, 0.1, (k, d)).astype(np.float32)
    w = rng.uniform(0.05, 0.45, k).astype(np.float32)
    tol = dict(rtol=2e-5, atol=2e-4 * d)
    _close(ref.mahalanobis_ref(_t(e), _t(lam)),
           jref.mahalanobis_ref(jnp.asarray(e), jnp.asarray(lam)),
           2e-5, 2e-4 * d * d)
    for got, want in zip(ref.figmn_matvecs_ref(_t(lam), _t(e), _t(m)),
                         jref.figmn_matvecs_ref(jnp.asarray(lam),
                                                jnp.asarray(e),
                                                jnp.asarray(m))):
        _close(got, want, **tol)
    got = ref.precision_rank2_update_ref(_t(lam), _t(e), _t(m), _t(w))
    want = jref.precision_rank2_update_ref(jnp.asarray(lam), jnp.asarray(e),
                                           jnp.asarray(m), jnp.asarray(w))
    scale = float(np.abs(np.asarray(want[0])).max())
    _close(got[0], want[0], 0, 5e-5 * scale)
    _close(got[1], want[1], 2e-5, 2e-4 * d * d)
    _close(got[2], want[2], 1e-4, 1e-5)
    got = ref.precision_rank1_update_exact_ref(_t(lam), _t(e), _t(w))
    want = jref.precision_rank1_update_exact_ref(
        jnp.asarray(lam), jnp.asarray(e), jnp.asarray(w))
    scale = float(np.abs(np.asarray(want[0])).max())
    _close(got[0], want[0], 0, 5e-5 * scale)
    _close(got[1], want[1], 2e-5, 2e-4 * d * d)


def _ops_inputs(k, d, seed):
    rng = np.random.default_rng(seed)
    lam = _psd(rng, k, d)
    e = rng.normal(0, 1, (k, d)).astype(np.float32)
    m = rng.normal(0, 0.1, (k, d)).astype(np.float32)
    w = rng.uniform(0.05, 0.45, k).astype(np.float32)
    logdet = rng.normal(0, 1, k).astype(np.float32)
    return lam, e, m, w, logdet


@pytest.mark.parametrize("k,d", [(4, 5), (3, 130)])
def test_ops_wrappers_match_reference_ops(k, d):
    """The port's ops (no padding) against repro.kernels.ops (padded to 128
    lanes, Pallas in interpret mode).  The port updates Λ in place, so each
    call gets its own copy."""
    lam, e, m, w, logdet = _ops_inputs(k, d, d * 7 + k)
    J = jnp.asarray
    _close(ops.matvec(_t(lam), _t(e)), jops.matvec(J(lam), J(e)),
           2e-5, 2e-4 * d)
    scale = float(np.abs(lam).max())
    pairs = [
        (ops.precision_rank2_update(_t(lam), _t(logdet), _t(e), _t(m),
                                    _t(w), d),
         jops.precision_rank2_update(J(lam), J(logdet), J(e), J(m), J(w), d)),
        (ops.precision_rank1_update_exact(_t(lam), _t(logdet), _t(e), _t(w),
                                          d),
         jops.precision_rank1_update_exact(J(lam), J(logdet), J(e), J(w), d)),
    ]
    y = np.asarray(jops.matvec(J(lam), J(e)))
    d2 = np.einsum("kd,kd->k", e, y).astype(np.float32)
    for mode in ("exact", "paper"):
        pairs.append((ops.fused_apply(_t(lam), _t(logdet), _t(y), _t(d2),
                                      _t(w), d, mode),
                      jops.fused_apply(J(lam), J(logdet), J(y), J(d2), J(w),
                                       d, mode)))
    for (glam, gld), (wlam, wld) in pairs:
        _close(glam, wlam, 0, 5e-5 * scale)
        _close(gld, wld, 0, 1e-4)


def test_ops_update_lambda_in_place():
    lam, e, m, w, logdet = _ops_inputs(3, 6, 1)
    t = _t(lam)
    out, _ = ops.precision_rank1_update_exact(t, _t(logdet), _t(e), _t(w), 6)
    assert out.data_ptr() == t.data_ptr()


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    lam, e, m, w, logdet = _ops_inputs(2, 6, 2)
    before = dict(_build.LAUNCHES)
    figmn_update.matvec2(_t(lam), _t(e), _t(m))
    figmn_update.rank2_apply(_t(lam), _t(e), None, _t(w), _t(w), None)
    assert _build.LAUNCHES == before          # plain versions launch nothing
    with pytest.raises(TypeError):
        figmn_update.matvec2(_t(lam).double(), _t(e).double())
    with pytest.raises(ValueError):
        figmn_update.matvec2(_t(lam).transpose(1, 2), _t(e))
    with pytest.raises(ValueError):
        figmn_update.matvec2(_t(lam), _t(e)[:, :5])
    with pytest.raises(ValueError):
        figmn_update.matvec2(_t(lam).to("meta"), _t(e).to("meta"))
    with pytest.raises(ValueError):
        figmn_update.rank2_apply(_t(lam), _t(e), _t(e), _t(w), _t(w), None)


@pytest.mark.parametrize("k,d,c", [(10, 6, 3), (5, 130, 4), (4, 257, 4)])
def test_gathered_matvec_plain_matches_reference_ops(k, d, c):
    """The port's gathered matvec against the Pallas kernel in interpret
    mode (as tests/test_shortlist.py runs it), at D not a multiple of 128."""
    rng = np.random.default_rng(k * 31 + d)
    lam = _psd(rng, k, d)
    diff = rng.normal(0, 1, (c, d)).astype(np.float32)
    idx = rng.permutation(k)[:c].astype(np.int32)
    want = jops.gathered_matvec(jnp.asarray(lam), jnp.asarray(diff),
                                jnp.asarray(idx), interpret=True)
    got = ops.gathered_matvec(_t(lam), _t(diff), torch.from_numpy(idx))
    _close(got, want, 2e-5, 2e-4 * d)
    assert torch.equal(got, figmn_sparse.gathered_matvec(
        _t(lam), _t(diff), torch.from_numpy(idx)))


@pytest.mark.parametrize("k,d,c", [(10, 6, 3), (5, 130, 4)])
@pytest.mark.parametrize("mode", ["exact", "paper"])
def test_scatter_fused_apply_plain_matches_reference_ops(k, d, c, mode):
    """The in-place shortlisted update against the aliased Pallas kernel in
    interpret mode: the C rows and their logdet to the tolerance of
    test_ops_wrappers_match_reference_ops (the paper-mode coefficient
    cancels, and XLA contracts its multiply-adds), the K − C other rows
    bit-equal, and a gated ω = 0 row a bit-exact no-op."""
    rng = np.random.default_rng(k * 17 + d + (mode == "paper"))
    lam = _psd(rng, k, d)
    logdet = rng.normal(0, 1, k).astype(np.float32)
    idx = rng.permutation(k)[:c].astype(np.int32)
    diff = rng.normal(0, 1, (c, d)).astype(np.float32)
    y = np.einsum("kde,ke->kd", lam[idx], diff).astype(np.float32)
    d2 = np.einsum("kd,kd->k", diff, y).astype(np.float32)
    w = rng.uniform(0.05, 0.4, c).astype(np.float32)
    w[0] = 0.0                                     # a gated (failed) row
    J = jnp.asarray
    wlam, wld = jops.scatter_fused_apply(J(lam), J(logdet), J(idx), J(y),
                                         J(d2), J(w), d, mode,
                                         interpret=True)
    tlam, tld = _t(lam), _t(logdet)
    glam, gld = ops.scatter_fused_apply(tlam, tld, torch.from_numpy(idx),
                                        _t(y), _t(d2), _t(w), d, mode)
    assert glam.data_ptr() == tlam.data_ptr()      # in place
    scale = float(np.abs(lam).max())
    _close(glam, wlam, 0, 5e-5 * scale)
    _close(gld, wld, 0, 1e-4)
    untouched = np.setdiff1d(np.arange(k), idx)
    np.testing.assert_array_equal(glam.numpy()[untouched], lam[untouched])
    np.testing.assert_array_equal(gld.numpy()[untouched], logdet[untouched])
    np.testing.assert_array_equal(glam.numpy()[idx[0]], lam[idx[0]])
    assert float(gld[idx[0]]) == float(logdet[idx[0]])


def test_scatter_apply_plain_keeps_the_pallas_association():
    rng = np.random.default_rng(3)
    k, d, c = 6, 9, 2
    lam = _psd(rng, k, d)
    y = rng.normal(0, 1, (c, d)).astype(np.float32)
    coefs = rng.uniform(0.5, 1.5, (c, 2)).astype(np.float32)
    idx = np.array([4, 1], np.int32)
    got = figmn_sparse.scatter_apply(_t(lam), _t(y), _t(coefs),
                                     torch.from_numpy(idx))
    want = lam.copy()
    for i, kk in enumerate(idx):
        want[kk] = lam[kk] * coefs[i, 0] \
            - (coefs[i, 1] * y[i])[:, None] * y[i][None, :]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,d", [(1, 4), (4, 5), (3, 130), (2, 256)])
def test_mahalanobis_plain_matches_reference_ops(k, d):
    """The port's mahalanobis_sq against the Pallas kernel in interpret mode
    behind repro.kernels.ops (tests/test_kernels.py's tolerance)."""
    rng = np.random.default_rng(k * 100 + d)
    lam = _psd(rng, k, d)
    diff = rng.normal(0, 1, (k, d)).astype(np.float32)
    want = jops.mahalanobis_sq(jnp.asarray(diff), jnp.asarray(lam),
                               interpret=True)
    got = ops.mahalanobis_sq(_t(diff), _t(lam))
    _close(got, want, 1e-5, 1e-5 * d)
    assert torch.equal(got, mahalanobis.mahalanobis(_t(diff), _t(lam)))


def test_sparse_wrappers_check_inputs_and_count_no_cpu_launch():
    rng = np.random.default_rng(4)
    lam = _t(_psd(rng, 5, 6))
    diff = _t(rng.normal(0, 1, (2, 6)))
    idx = torch.tensor([3, 1], dtype=torch.int32)
    coefs = torch.ones((2, 2))
    before = dict(_build.LAUNCHES)
    figmn_sparse.gathered_matvec(lam, diff, idx)
    figmn_sparse.scatter_apply(lam.clone(), diff, coefs, idx)
    mahalanobis.mahalanobis(diff, lam[:2].contiguous())
    assert _build.LAUNCHES == before          # plain versions launch nothing
    with pytest.raises(TypeError, match="int32"):
        figmn_sparse.gathered_matvec(lam, diff, idx.long())
    with pytest.raises(ValueError):
        figmn_sparse.gathered_matvec(lam, diff, idx[:1])
    with pytest.raises(ValueError):
        figmn_sparse.scatter_apply(lam, diff, coefs[:, :1].contiguous(), idx)
    with pytest.raises(TypeError):
        mahalanobis.mahalanobis(diff.double(), lam[:2].double())
    with pytest.raises(ValueError):
        figmn_sparse.gathered_matvec(lam.to("meta"), diff.to("meta"),
                                     idx.to("meta"))


def test_resident_working_set_formula():
    """smem_bytes mirrors the kernel's shared-memory layout: the sweep's
    (D=32, K=16) cell fits an H100 block (227 KB), (D=64, K=32) does not."""
    assert figmn_stream.smem_bytes(16, 32) == 4 * (16 * 32 * 32 + 3 * 16 * 32
                                                   + 7 * 16 + 32)
    assert figmn_stream.smem_bytes(16, 32) <= 232448
    assert figmn_stream.smem_bytes(32, 64) > 232448


H100_SMEM, H100_BLOCKS = 232448, 132


def _blocks_of_component(plan, k, d, comp):
    """The blocks whose rows the grid kernel sums for component ``comp``,
    with its index among each block's components: the kernel's formula
    (first block ⌊comp·D/R⌋, last ⌊((comp+1)·D − 1)/R⌋, slot
    comp − ⌊b·R/D⌋)."""
    r = plan.rows
    return [(b, comp - (b * r) // d)
            for b in range((comp * d) // r, ((comp + 1) * d - 1) // r + 1)]


@pytest.mark.parametrize("k,d,blocks", [
    (32, 256, None), (32, 64, None), (256, 32, None), (3, 1024, None),
    (1, 1773, None), (12288, 16, None), (16, 32, 3), (4, 8, 5), (5, 7, 4)])
def test_grid_plan_covers_every_row_once(k, d, blocks):
    """The plan's blocks tile the K·D rows of the Λ stack exactly; each
    block's shared memory is within the limit and its components within
    ``nc``; the kernel's per-component block formula finds exactly the
    blocks that hold the component's rows."""
    plan = figmn_stream.grid_plan(k, d, H100_SMEM, H100_BLOCKS, blocks)
    assert plan.blocks <= H100_BLOCKS and plan.smem_bytes <= H100_SMEM
    assert plan.smem_bytes == figmn_stream.grid_smem_bytes(plan.rows,
                                                           plan.nc, d)
    if blocks is not None:
        assert plan.blocks == blocks
    spans = figmn_stream.plan_blocks(plan, k, d)
    rows = np.concatenate([np.arange(r0, r0 + n) for r0, n in spans])
    np.testing.assert_array_equal(rows, np.arange(k * d))
    assert all(n >= 1 for _, n in spans)
    owners = {}
    for b, (r0, n) in enumerate(spans):
        comps = range(r0 // d, (r0 + n - 1) // d + 1)
        assert len(comps) <= plan.nc
        for c in comps:
            owners.setdefault(c, []).append((b, c - r0 // d))
    for comp in range(k):
        assert _blocks_of_component(plan, k, d, comp) == owners[comp]


def test_grid_plan_spreads_and_straddles():
    """Unforced, a pool goes over ⌈K·D/64⌉ blocks up to the card's count;
    the forced three-block plan of the (K = 16, D = 32) cell cuts inside
    components, so components straddle blocks."""
    p = figmn_stream.grid_plan(32, 256, H100_SMEM, H100_BLOCKS)
    assert (p.rows, p.blocks, p.nc) == (64, 128, 2)
    p = figmn_stream.grid_plan(48, 256, H100_SMEM, H100_BLOCKS)
    assert p.rows == -(-48 * 256 // 132) == 94
    assert p.blocks == -(-48 * 256 // 94) == 131       # no empty block
    p = figmn_stream.grid_plan(16, 32, H100_SMEM, H100_BLOCKS, blocks=3)
    assert (p.rows, p.blocks) == (171, 3) and p.rows % 32 != 0
    straddling = [b for b, (r0, n) in enumerate(
        figmn_stream.plan_blocks(p, 16, 32)) if r0 % 32 or (r0 + n) % 32]
    assert straddling == [0, 1, 2]
    # one row of D = 1773 floats: fewer rows per block, more blocks
    p = figmn_stream.grid_plan(1, 1773, H100_SMEM, H100_BLOCKS)
    assert p.rows < 64 and p.blocks == -(-1773 // p.rows)


def test_grid_plan_raises_beyond_capacity():
    # 32 MiB of Λ: beyond 132 blocks of 227 KB
    with pytest.raises(ValueError, match="co-resident"):
        figmn_stream.grid_plan(128, 256, H100_SMEM, H100_BLOCKS)
    with pytest.raises(ValueError, match="co-resident"):
        figmn_stream.grid_plan(32, 64, H100_SMEM, 2)
    with pytest.raises(ValueError, match="does not fit"):
        figmn_stream.grid_plan(1, 60000, H100_SMEM, H100_BLOCKS)
    with pytest.raises(ValueError, match="do not fit"):
        figmn_stream.grid_plan(32, 256, H100_SMEM, H100_BLOCKS, blocks=4)
    with pytest.raises(ValueError, match="empty"):
        figmn_stream.grid_plan(0, 8, H100_SMEM, H100_BLOCKS)
    # no cooperative launch: no block
    with pytest.raises(ValueError, match="co-resident"):
        figmn_stream.grid_plan(32, 64, H100_SMEM, 0)


def test_resident_plan_picks_one_block_or_the_grid():
    cpu = torch.device("cpu")
    assert figmn_stream.resident_plan(16, 32, cpu, H100_SMEM,
                                      H100_BLOCKS) is None
    assert figmn_stream.resident_plan(32, 64, cpu, H100_SMEM, H100_BLOCKS) \
        == figmn_stream.grid_plan(32, 64, H100_SMEM, H100_BLOCKS)


def test_stream_wrapper_takes_the_plain_version_on_cpu_with_a_plan():
    cfg, state, xs = _formed_mixture(d=8)
    s = {f: np.array(getattr(state, f)) for f in ("mu", "lam", "logdet",
                                                   "sp", "active")}
    args = (_t(xs), _t(s["mu"]), _t(s["lam"]), _t(s["logdet"]),
            _t(s["sp"]), torch.from_numpy(s["active"].astype(np.int32)),
            float(jchi2(8, 1.0 - cfg.beta)), 8)
    plan = figmn_stream.grid_plan(4, 8, H100_SMEM, H100_BLOCKS, blocks=3)
    before = dict(_build.LAUNCHES)
    got = figmn_stream.figmn_stream(*args, plan=plan)
    want = ref.figmn_stream_ref(*args)
    assert _build.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _warp_dot(a, b):
    """Σ a·b over the last axis in csrc/figmn_stream_grid.cu's order: lane
    l sums the products j ≡ l (mod 32) in order, then a butterfly of
    __shfl_xor_sync over the 32 lanes (float32, no contraction)."""
    p = a * b
    pad = (-p.shape[-1]) % 32
    if pad:
        p = torch.cat([p, p.new_zeros(p.shape[:-1] + (pad,))], -1)
    p = p.reshape(p.shape[:-1] + (-1, 32))
    acc = p.new_zeros(p.shape[:-2] + (32,))
    for c in range(p.shape[-2]):
        acc = acc + p[..., c, :]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def _grid_order_loop(xs, mu, lam, logdet, sp, active, thresh, dim, plan):
    """figmn_stream_ref with the grid kernel's summation orders: y and the
    per-block d² partials by ``_warp_dot``, the partials summed in block
    order, the posterior's normaliser over 16 warps of 32 lanes."""
    k, d = mu.shape
    act = active.bool()
    spans = figmn_stream.plan_blocks(plan, k, d)
    log_norm = torch.tensor(dim * 1.8378770664093453, dtype=torch.float32)
    nacc = 0
    for t in range(xs.shape[0]):
        diff = xs[t][None] - mu
        y = _warp_dot(lam, diff[:, None, :])
        yf, df = y.reshape(-1), diff.reshape(-1)
        d2 = torch.zeros(k)
        for c in range(k):
            s = torch.zeros(())
            for r0, n in spans:
                a, z = max(r0, c * d), min(r0 + n, (c + 1) * d)
                if a < z:
                    s = s + _warp_dot(df[a:z], yf[a:z])
            d2[c] = s
        accept = bool(torch.any(act & (d2 < thresh)))
        lw = torch.where(act, -0.5 * ((log_norm + logdet) + d2)
                         + torch.log(sp.clamp_min(1e-30)),
                         torch.full_like(d2, -1e30))
        p = torch.where(act, torch.exp(lw - lw.max()), torch.zeros_like(lw))
        warps = torch.cat([p, p.new_zeros(512 - k)]).reshape(16, 32)
        lanes = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            warps = warps + warps[:, lanes ^ o]
        s = torch.zeros(())
        for i in range(16):
            s = s + warps[i, 0]
        post = p / s.clamp_min(1e-30) if accept else torch.zeros_like(p)
        sp_new = sp + post
        w = post / sp_new.clamp_min(1e-30)
        om = 1.0 - w
        beta = w / (1.0 + w * d2)
        logdet = logdet + (dim * torch.log(om) + torch.log1p(w * d2))
        sp = sp_new
        mu = mu + w[:, None] * diff
        lam = (lam - (beta[:, None] * y)[:, None, :] * y[:, :, None]) \
            / om[:, None, None]
        nacc += accept
    return mu, lam, logdet, sp, nacc


def test_grid_summation_order_stays_inside_the_limit():
    """The error model behind chip_smoke.py's grid-kernel limits, on the
    CPU: the plain loop with the grid kernel's summation orders (G = 3,
    rows straddling components) stays within 16·√(N·D)·u of each
    quantity's scale of the plain version, with the same accepts."""
    rng = np.random.default_rng(1)
    k, d, n = 16, 32, 256
    centers = rng.normal(0, 6.0, (4, d))
    x = torch.from_numpy((centers[rng.integers(0, 4, n + 512)]
                          + rng.normal(0, 1.0, (n + 512, d)))
                         .astype(np.float32))
    cfg = FIGMNConfig(kmax=k, dim=d, beta=0.1, delta=1.0, vmin=1e9,
                      spmin=0.0, update_mode="exact",
                      sigma_ini=figmn.sigma_from_data(x, 1.0))
    st = figmn.fit(cfg, figmn.init_state(cfg, "cpu"), x[:512])
    args = (x[512:].contiguous(), st.mu, st.lam, st.logdet, st.sp,
            st.active.to(torch.int32), gate_threshold(cfg), d)
    plan = figmn_stream.grid_plan(k, d, H100_SMEM, H100_BLOCKS, blocks=3)
    want = ref.figmn_stream_ref(*args)
    got = _grid_order_loop(*args, plan)
    assert got[4] == int(want[4][0]) > 0
    limit = 16 * np.sqrt(n * d) * 2.0 ** -24
    m = st.active
    for g, w in zip(got[:4], want[:4]):
        scale = float(w[m].abs().max())
        assert float((g[m] - w[m]).abs().max()) <= limit * scale
