"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  A CUDA kernel has no CPU mode, so without a card every test here
skips.  This file imports neither JAX nor the reference package, so it runs
on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: a matvec's two summation orders differ by at most 2·D·u·Σ|terms|
(u = 2⁻²⁴); rank2_apply rounds exactly as its plain version (same
association, no multiply-add contraction), so 4 ulps of the largest entry;
the resident kernel over a chunk uses tests/test_figmn_stream_kernel.py's
tolerances (1e-3).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import figmn
from repro_torch.core.types import FIGMNConfig, gate_threshold
from repro_torch.kernels import _build, figmn_stream, figmn_update, ref

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
    k, d = 32, 64
    assert figmn_stream.smem_bytes(k, d) > _build.smem_optin(cuda)
    z = torch.zeros((k, d), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        figmn_stream.figmn_stream(
            torch.zeros((4, d), device=cuda), z,
            torch.zeros((k, d, d), device=cuda), z[:, 0].contiguous(),
            z[:, 0].contiguous(), torch.zeros(k, dtype=torch.int32,
                                              device=cuda), 1.0, d)
