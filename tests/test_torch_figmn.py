"""The port's learner (``repro_torch.core``) against ``repro.core`` on the
same numpy-seeded streams, on the CPU.

Tolerances: float32.  One learning step matches to a few ulps (sums over D
and K are taken in another order than XLA's); over a stream the per-step
differences accumulate, so the end states are compared with rtol/atol 1e-4
(Λ relative to its largest entry).  Every stream here keeps its gate
decisions away from the threshold: ``n_created`` must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import figmn as jfigmn
from repro.core.types import FIGMNConfig as JConfig
from repro.core.types import chi2_quantile as jchi2
from repro_torch import interop
from repro_torch.core import figmn
from repro_torch.core.types import chi2_quantile, gate_threshold, ndtri32

FIELDS = interop.STATE_FIELDS

CHI2_DOFS = [1, 2, 3, 5, 8, 16, 32, 64, 100, 256, 794, 1000]
CHI2_BETAS = [0.3, 0.2, 0.1, 0.05, 0.02, 0.01, 0.005, 0.001, 1e-4]


@pytest.mark.parametrize("dof", CHI2_DOFS)
@pytest.mark.parametrize("beta", CHI2_BETAS)
def test_chi2_quantile_matches_reference_float32(dof, beta):
    """The gate threshold is the reference's float32 value bit for bit."""
    want = np.float32(jchi2(dof, 1.0 - beta))
    got = np.float32(chi2_quantile(dof, 1.0 - beta).numpy())
    assert got.view(np.uint32) == want.view(np.uint32), \
        (float(got) - float(want)) / float(np.spacing(want))


def test_chi2_quantile_matches_reference_on_random_pairs():
    rng = np.random.default_rng(0)
    for _ in range(200):
        dof = int(rng.integers(1, 1200))
        beta = float(10 ** rng.uniform(-5, np.log10(0.5)))
        want = np.float32(jchi2(dof, 1.0 - beta))
        got = np.float32(chi2_quantile(dof, 1.0 - beta).numpy())
        assert got.view(np.uint32) == want.view(np.uint32), (dof, beta)


def test_ndtri32_matches_reference_ndtri():
    """The port's float32 Φ⁻¹ against jax.scipy.special.ndtri over both
    rational forms, the complement and the z ≥ 8 tail."""
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.uniform(0, 1, 400),
                        10.0 ** rng.uniform(-30, -1, 200),
                        1 - 10.0 ** rng.uniform(-7, -1, 200),
                        [0.0, 1.0, 0.5]]).astype(np.float32)
    want = np.asarray(jax.scipy.special.ndtri(jnp.asarray(p)))
    got = np.array([ndtri32(v) for v in p], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_chi2_quantile_beta_zero_is_inf():
    assert torch.isinf(chi2_quantile(5, 1.0))


def _stream(n, d, modes, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 6.0, (modes, d))
    x = centers[rng.integers(0, modes, n)] + rng.normal(0, 1.0, (n, d))
    return x.astype(np.float32)


def _configs(x, **kw):
    """The same config for both packages (one dict drives both)."""
    sigma = np.asarray(jfigmn.sigma_from_data(jnp.asarray(x), 1.0))
    jcfg = JConfig(dim=x.shape[1], delta=1.0, sigma_ini=jnp.asarray(sigma),
                   **kw)
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["sigma_ini"] = sigma
    tcfg = interop.config_from_dict(d)
    assert gate_threshold(tcfg) == float(jchi2(tcfg.dim, 1.0 - tcfg.beta))
    return jcfg, tcfg


def _numpy(state):
    return {f: np.array(getattr(state, f)) for f in FIELDS}


def _assert_states_close(got, want, tol=1e-4):
    g, w = interop.state_to_numpy(got), _numpy(want)
    assert int(g["n_created"]) == int(w["n_created"])
    np.testing.assert_array_equal(g["active"], w["active"])
    np.testing.assert_array_equal(g["v"], w["v"])
    scale = float(np.abs(w["lam"]).max())
    np.testing.assert_allclose(g["lam"], w["lam"], rtol=tol, atol=tol * scale)
    for f in ("mu", "logdet", "sp"):
        np.testing.assert_allclose(g[f], w[f], rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["paper", "exact"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_learn_one_stepwise_parity(mode, fused, backend):
    x = _stream(48, 5, 3, seed=3)
    jcfg, tcfg = _configs(x, kmax=6, beta=0.1, update_mode=mode,
                          fused=fused, backend=backend)
    jstep = jax.jit(jfigmn.learn_one, static_argnames=("do_prune",))
    js = jfigmn.init_state(jcfg)
    ts = figmn.init_state(tcfg, "cpu")
    for i in range(x.shape[0]):
        js = jstep(jcfg, js, jnp.asarray(x[i]))
        ts = figmn.learn_one(tcfg, ts, torch.from_numpy(x[i]))
        _assert_states_close(ts, js, tol=2e-5)


@pytest.mark.parametrize("mode", ["paper", "exact"])
def test_fit_end_state_and_score_parity(mode):
    x = _stream(160, 3, 3, seed=11)
    jcfg, tcfg = _configs(x, kmax=8, beta=0.1, update_mode=mode)
    js = jfigmn.fit(jcfg, jfigmn.init_state(jcfg), jnp.asarray(x))
    ts = figmn.fit(tcfg, figmn.init_state(tcfg, "cpu"), torch.from_numpy(x))
    _assert_states_close(ts, js)
    q = _stream(40, 3, 3, seed=12)
    np.testing.assert_allclose(
        figmn.score_batch(tcfg, ts, torch.from_numpy(q)).numpy(),
        np.asarray(jfigmn.score_batch(jcfg, js, jnp.asarray(q))),
        rtol=1e-4, atol=1e-4)


def test_score_batch_blocks_rows_identically():
    """Blocking the (B, K, D) pass never changes a row."""
    x = _stream(120, 4, 2, seed=5)
    _, tcfg = _configs(x, kmax=6, beta=0.1, update_mode="exact")
    ts = figmn.fit(tcfg, figmn.init_state(tcfg, "cpu"), torch.from_numpy(x))
    xs = torch.from_numpy(x)
    one = figmn.log_likelihood_batch(tcfg, ts, xs, block_b=512)
    blocked = figmn.log_likelihood_batch(tcfg, ts, xs, block_b=7)
    torch.testing.assert_close(blocked, one, rtol=1e-6, atol=1e-5)
    single = torch.stack([figmn.log_likelihood(tcfg, ts, xs[i])
                          for i in range(5)])
    torch.testing.assert_close(single, one[:5], rtol=1e-5, atol=1e-4)


def test_sigma_from_data_matches_reference():
    x = _stream(200, 6, 2, seed=2)
    x[:, 3] = 1.5                               # a constant dimension
    np.testing.assert_allclose(
        figmn.sigma_from_data(torch.from_numpy(x), 0.5).numpy(),
        np.asarray(jfigmn.sigma_from_data(jnp.asarray(x), 0.5)),
        rtol=1e-6)


def test_state_round_trip_through_interop():
    """A reference state carried across, stepped by both packages, stays
    within one step's tolerance; numpy → port → numpy is exact."""
    x = _stream(60, 4, 2, seed=8)
    jcfg, tcfg = _configs(x, kmax=5, beta=0.1, update_mode="exact")
    js = jfigmn.fit(jcfg, jfigmn.init_state(jcfg), jnp.asarray(x[:50]))
    payload = _numpy(js)
    ts = interop.state_from_numpy(payload, device="cpu")
    back = interop.state_to_numpy(ts)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], payload[f])
        assert back[f].dtype == payload[f].dtype
    js = jfigmn.fit(jcfg, js, jnp.asarray(x[50:]))
    ts = figmn.fit(tcfg, ts, torch.from_numpy(x[50:]))
    _assert_states_close(ts, js, tol=2e-5)
    cfg_back = interop.config_from_dict(interop.config_to_dict(tcfg))
    assert dataclasses.replace(cfg_back, sigma_ini=None) \
        == dataclasses.replace(tcfg, sigma_ini=None)
    np.testing.assert_array_equal(cfg_back.sigma_ini, tcfg.sigma_ini)


def test_create_recycles_weakest_when_pool_is_full():
    """A full pool recycles the lowest-sp slot (first index on ties)."""
    x = _stream(40, 3, 6, seed=4)
    jcfg, tcfg = _configs(x, kmax=2, beta=0.1, update_mode="exact",
                          spmin=0.0)
    js = jfigmn.fit(jcfg, jfigmn.init_state(jcfg), jnp.asarray(x))
    ts = figmn.fit(tcfg, figmn.init_state(tcfg, "cpu"), torch.from_numpy(x))
    assert int(ts.n_created) > 2
    _assert_states_close(ts, js)


def test_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs(_stream(10, 3, 1, seed=0), kmax=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        figmn.init_state(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.state_from_numpy(
            interop.state_to_numpy(figmn.init_state(tcfg, "cpu")))
