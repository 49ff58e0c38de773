"""The port's top-C shortlist path (``repro_torch.core.shortlist``, the
shortlisted reads of ``core.inference`` and the "sparse" ingest path)
against ``repro.core.shortlist`` / ``repro.core.inference`` on the CPU, and
its structural contracts port-vs-port.

The reference's "pallas" backend runs its Pallas kernels in interpret mode;
the port's takes the kernels' plain versions on the CPU.  Tolerances as in
tests/test_torch_runtime.py: states rtol/atol 2e-5 per step and 1e-4 over a
stream (Λ relative to its largest entry), scores 1e-4, eq. 27 reads 1e-3.
Every stream keeps its gate decisions and shortlists away from ties, so
``n_created`` and ``active`` match exactly.  Port-vs-port contracts (C = K
≡ dense fit, C covering the pool ≡ dense predict, chunked ≡ one-shot, rows
outside the shortlist untouched) are bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import figmn as jfigmn
from repro.core import inference as jinference
from repro.core import shortlist as jshortlist
from repro.core.types import FIGMNConfig as JConfig
from repro.core.types import chi2_quantile as jchi2
from repro.stream import RuntimeConfig as JRuntimeConfig
from repro.stream import StreamRuntime as JStreamRuntime
from repro_torch import interop
from repro_torch.api import Mixture, MixtureSpec
from repro_torch.core import figmn, inference, shortlist
from repro_torch.core.types import gate_threshold
from repro_torch.stream import RuntimeConfig, StreamRuntime, select_path

FIELDS = interop.STATE_FIELDS


def _stream(n, d, modes, seed, spread=6.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, spread, (modes, d))
    x = centers[rng.integers(0, modes, n)] + rng.normal(0, 1.0, (n, d))
    return x.astype(np.float32)


def _configs(x, **kw):
    """The same config for both packages (one dict drives both)."""
    sigma = np.asarray(jfigmn.sigma_from_data(jnp.asarray(x), 1.0))
    kw = dict(dict(delta=1.0, vmin=1e9, spmin=0.0, beta=0.1), **kw)
    jcfg = JConfig(dim=x.shape[1], sigma_ini=jnp.asarray(sigma), **kw)
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


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _to_port(js):
    return interop.state_from_numpy(_numpy(js), device="cpu")


# ---------------------------------------------------------------------------
# the write path against the reference
# ---------------------------------------------------------------------------

# (kmax, C): C < active K (the streams form 5–7 components) and
# active K ≤ C < K
CASES = [(8, 2), (12, 8)]


@pytest.mark.parametrize("mode", ["exact", "paper"])
@pytest.mark.parametrize("kmax,c", CASES)
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_learn_one_sparse_stepwise_parity(mode, kmax, c, backend):
    x = _stream(60, 4, 4, seed=3)
    jcfg, tcfg = _configs(x, kmax=kmax, shortlist_c=c, update_mode=mode,
                          backend=backend)
    jstep = jax.jit(jshortlist.learn_one_sparse,
                    static_argnames=("do_prune",))
    js = jfigmn.init_state(jcfg)
    jd = jshortlist.lam_diag(js)
    ts = figmn.init_state(tcfg, "cpu")
    td = shortlist.lam_diag(ts)
    for i in range(x.shape[0]):
        js, jd = jstep(jcfg, js, jd, jnp.asarray(x[i]))
        ts, td = shortlist.learn_one_sparse(tcfg, ts, td,
                                            torch.from_numpy(x[i]))
        _assert_states_close(ts, js, tol=2e-5)
        scale = float(np.abs(np.asarray(jd)).max())
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-5,
                                   atol=2e-5 * scale)
    assert (int(ts.n_active) > c) == (c == 2)


@pytest.mark.parametrize("mode", ["exact", "paper"])
@pytest.mark.parametrize("kmax,c", CASES)
def test_fit_sparse_matches_reference(mode, kmax, c):
    x = _stream(200, 5, 4, seed=11)
    jcfg, tcfg = _configs(x, kmax=kmax, shortlist_c=c, update_mode=mode)
    js = jshortlist.fit_sparse(jcfg, jfigmn.init_state(jcfg),
                               jnp.asarray(x))
    ts = shortlist.fit_sparse(tcfg, figmn.init_state(tcfg, "cpu"),
                              torch.from_numpy(x))
    assert (int(ts.n_active) > c) == (c == 2)
    _assert_states_close(ts, js)


def test_fit_sparse_euclid_proxy_matches_reference():
    x = _stream(160, 5, 4, seed=12)
    jcfg, tcfg = _configs(x, kmax=8, shortlist_c=2, update_mode="exact",
                          shortlist_mode="euclid")
    js = jshortlist.fit_sparse(jcfg, jfigmn.init_state(jcfg),
                               jnp.asarray(x))
    ts = shortlist.fit_sparse(tcfg, figmn.init_state(tcfg, "cpu"),
                              torch.from_numpy(x))
    assert int(ts.n_active) > 2
    _assert_states_close(ts, js)


def test_fit_sparse_kernel_backend_at_d130_matches_reference():
    """The "pallas" backend at a D that is not a multiple of 128 (the
    reference's kernels in interpret mode, the port's plain versions)."""
    x = _stream(48, 130, 3, seed=5, spread=3.0)
    jcfg, tcfg = _configs(x, kmax=6, shortlist_c=2, update_mode="exact",
                          backend="pallas", beta=0.05)
    js = jshortlist.fit_sparse(jcfg, jfigmn.init_state(jcfg),
                               jnp.asarray(x))
    ts = shortlist.fit_sparse(tcfg, figmn.init_state(tcfg, "cpu"),
                              torch.from_numpy(x))
    assert int(ts.n_active) >= 3
    _assert_states_close(ts, js)


# ---------------------------------------------------------------------------
# structural contracts, port-vs-port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "paper"])
@pytest.mark.parametrize("spmin", [0.0, 3.0])
def test_fit_sparse_at_c_equal_k_bitidentical_to_dense(mode, spmin):
    """At C = K the gather is the identity permutation and the sparse step
    runs the dense fused formulas on the same values in the same order."""
    x = _stream(220, 5, 3, seed=0, spread=7.0)
    _, tcfg = _configs(x, kmax=12, shortlist_c=12, update_mode=mode,
                       spmin=spmin, vmin=5.0)
    want = figmn.fit(tcfg, figmn.init_state(tcfg, "cpu"), torch.from_numpy(x))
    got = shortlist.fit_sparse(tcfg, figmn.init_state(tcfg, "cpu"),
                               torch.from_numpy(x))
    _same(got, want)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("accept", [True, False])
def test_learn_one_sparse_touches_only_shortlist_rows(backend, accept):
    """Every row outside the shortlist and the creation slot comes back
    bit-equal; the in-place Λ write leaves the other K − C rows alone."""
    x = _stream(120, 4, 4, seed=7)
    _, tcfg = _configs(x, kmax=12, shortlist_c=3, update_mode="exact",
                       backend=backend)
    state = shortlist.fit_sparse(tcfg, figmn.init_state(tcfg, "cpu"),
                                 torch.from_numpy(x))
    diag = shortlist.lam_diag(state)
    point = torch.from_numpy(x[5] if accept else x[5] + 40.0)
    idx = shortlist.topc(shortlist.shortlist_scores(tcfg, state, diag, point),
                         3)
    free = ~state.active
    slot = int(torch.argmax(free.to(torch.int32))) if bool(free.any()) \
        else int(torch.argmin(torch.where(state.active, state.sp,
                                          torch.full_like(state.sp,
                                                          torch.inf))))
    before, diag0 = state.clone(), diag.clone()
    new, diag1 = shortlist.learn_one_sparse(tcfg, state, diag, point)
    created = int(new.n_created) - int(before.n_created)
    assert created == (0 if accept else 1)
    touched = set(idx.tolist()) | {slot}
    untouched = [k for k in range(tcfg.kmax) if k not in touched]
    assert untouched
    for f in ("mu", "lam", "logdet", "sp", "active"):
        assert torch.equal(getattr(new, f)[untouched],
                           getattr(before, f)[untouched]), f
    assert torch.equal(diag1[untouched], diag0[untouched])
    if accept:
        assert not torch.equal(new.sp[idx], before.sp[idx])
    else:
        assert torch.equal(new.lam[idx], before.lam[idx])
        assert torch.equal(new.mu[slot], point)


@pytest.mark.parametrize("chunk", [32, 7])
def test_chunked_sparse_ingest_equals_one_fit_sparse(chunk):
    x = _stream(150, 4, 4, seed=4)
    _, tcfg = _configs(x, kmax=8, shortlist_c=3, update_mode="exact",
                       spmin=1.0, vmin=20.0)
    want = shortlist.fit_sparse(tcfg, figmn.init_state(tcfg, "cpu"),
                                torch.from_numpy(x))
    rt = StreamRuntime(tcfg, RuntimeConfig(chunk=chunk, device="cpu"))
    assert rt.path == "sparse"
    rt.ingest(x[:64])
    rt.ingest(x[64:])
    _same(rt.state, want)
    assert {m.path for m in rt.telemetry.history} == {"sparse"}


def test_topc_breaks_ties_as_lax_top_k():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 4, (6, 16)).astype(np.float32)
    s[rng.random((6, 16)) < 0.3] = -np.inf
    s[0] = -np.inf                                  # an empty pool
    s[1] = 2.0                                      # every slot tied
    for c in (1, 3, 8, 16):
        want = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(s), c)[1]),
                       axis=1)
        got = shortlist.topc(torch.from_numpy(s), c)
        np.testing.assert_array_equal(got.numpy(), want)
        for b in range(s.shape[0]):            # the write path's (K,) call
            np.testing.assert_array_equal(
                shortlist.topc(torch.from_numpy(s[b]), c).numpy(),
                np.asarray(jshortlist.topc(jnp.asarray(s[b]), c)))
    np.testing.assert_array_equal(
        shortlist.topc(torch.from_numpy(s[0]), 16).numpy(), np.arange(16))


def test_select_path_dispatch_and_effective_c():
    x = _stream(10, 3, 1, seed=0)
    _, tcfg = _configs(x, kmax=6, shortlist_c=3)
    assert select_path(tcfg, device="cpu") == "sparse"
    assert select_path(tcfg, requested="sparse", device="cpu") == "sparse"
    assert select_path(tcfg, requested="scan", device="cpu") == "scan"
    dense = dataclasses.replace(tcfg, shortlist_c=0)
    assert select_path(dense, device="cpu") == "scan"
    with pytest.raises(ValueError, match="shortlist_c > 0"):
        select_path(dense, requested="sparse", device="cpu")
    with pytest.raises(ValueError, match="fused"):
        shortlist.effective_c(dataclasses.replace(tcfg, fused=False))
    with pytest.raises(ValueError, match="shortlist_c > 0"):
        shortlist.effective_c(dense)
    assert shortlist.effective_c(dataclasses.replace(tcfg,
                                                     shortlist_c=64)) == 6


# ---------------------------------------------------------------------------
# the read path against the reference
# ---------------------------------------------------------------------------

FEATURES, CLASSES = 4, 3
DIM = FEATURES + CLASSES
TARGETS = list(range(FEATURES, DIM))


def _joint(n, seed):
    """Class-conditional Gaussians joined with a one-hot label block."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 4.0, (CLASSES, FEATURES))
    y = rng.integers(0, CLASSES, n)
    x = means[y] + rng.normal(0, 1.0, (n, FEATURES))
    return np.concatenate([x, np.eye(CLASSES)[y]], 1).astype(np.float32), y


def _formed(mode, c, kmax=10):
    x, _ = _joint(160, seed=21)
    jcfg, tcfg = _configs(x, kmax=kmax, shortlist_c=c, update_mode=mode)
    js = jshortlist.fit_sparse(jcfg, jfigmn.init_state(jcfg),
                               jnp.asarray(x))
    return jcfg, tcfg, js, _to_port(js)


@pytest.mark.parametrize("mode", ["exact", "paper"])
@pytest.mark.parametrize("c", [2, 10])
@pytest.mark.parametrize("proxy", ["diag", "euclid"])
def test_sparse_reads_match_reference(mode, c, proxy):
    """score_batch_sparse, chunk_stats_sparse and predict_batch_sparse on
    one state carried across, under both shortlist proxies; the port's
    (B, C) products take the gathered matvec's plain version on the CPU."""
    jcfg, tcfg, js, ts = _formed(mode, c)
    jcfg = dataclasses.replace(jcfg, shortlist_mode=proxy)
    tcfg = dataclasses.replace(tcfg, shortlist_mode=proxy)
    q, _ = _joint(50, seed=22)
    _close(shortlist.score_batch_sparse(tcfg, ts, torch.from_numpy(q)),
           jshortlist.score_batch_sparse(jcfg, js, jnp.asarray(q)), 1e-4)
    # blocking never changes the shortlist of a row
    _close(shortlist.score_batch_sparse(tcfg, ts, torch.from_numpy(q),
                                        block_b=16),
           jshortlist.score_batch_sparse(jcfg, js, jnp.asarray(q)), 1e-4)
    thresh = gate_threshold(tcfg)
    fails, ll = shortlist.chunk_stats_sparse(tcfg, ts, torch.from_numpy(q),
                                             thresh)
    jfails, jll = jshortlist.chunk_stats_sparse(jcfg, js, jnp.asarray(q),
                                                jnp.float32(thresh))
    np.testing.assert_array_equal(fails.numpy(), np.asarray(jfails))
    _close(ll, jll, 1e-5)
    qi = q[:, :FEATURES]
    got = inference.predict_batch_sparse(tcfg, ts, qi, TARGETS)
    want = jinference.predict_batch_sparse(jcfg, js, jnp.asarray(qi),
                                           TARGETS)
    _close(got, want, 1e-3)
    mean, var = inference.predict_batch_sparse(tcfg, ts, qi, TARGETS,
                                               return_var=True)
    jmean, jvar = jinference.predict_batch_sparse(
        jcfg, js, jnp.asarray(qi), TARGETS, return_var=True)
    _close(mean, jmean, 1e-3)
    _close(var, jvar, 1e-3)


def _as_float64(state):
    return dataclasses.replace(state, **{
        f: getattr(state, f).double() for f in ("mu", "lam", "logdet", "sp",
                                                 "v")})


@pytest.mark.parametrize("c", [2, 10])
def test_sparse_reads_in_float64_on_the_cpu(c):
    """A float64 state reads on the CPU (the gathered products take their
    plain version at any dtype there): float64 out, within the float32
    tolerances of the reference's reads of the same state, and at C = K
    within 1e-10 of the dense float64 score."""
    jcfg, tcfg, js, ts = _formed("exact", c)
    cfg64 = dataclasses.replace(tcfg, dtype_str="float64")
    ts64 = _as_float64(ts)
    q, _ = _joint(50, seed=22)
    q64 = torch.from_numpy(q.astype(np.float64))
    got = shortlist.score_batch_sparse(cfg64, ts64, q64)
    assert got.dtype == torch.float64
    _close(got, jshortlist.score_batch_sparse(jcfg, js, jnp.asarray(q)),
           1e-4)
    if c == tcfg.kmax:
        _close(got, figmn.score_batch(cfg64, ts64, q64), 1e-10)
    qi = q64[:, :FEATURES]
    mean = inference.predict_batch_sparse(cfg64, ts64, qi, TARGETS)
    assert mean.dtype == torch.float64
    _close(mean, jinference.predict_batch_sparse(
        jcfg, js, jnp.asarray(q[:, :FEATURES]), TARGETS), 1e-3)


@pytest.mark.parametrize("c", [10, 64])
def test_predict_sparse_covering_pool_bitidentical_to_dense(c):
    _, tcfg, _, ts = _formed("exact", c)
    qi = _joint(70, seed=23)[0][:, :FEATURES]
    assert torch.equal(
        inference.predict_batch_sparse(tcfg, ts, qi, TARGETS, c=c),
        inference.predict_batch(tcfg, ts, qi, TARGETS))
    for got, want in zip(
            inference.predict_batch_sparse(tcfg, ts, qi, TARGETS, c=c,
                                           return_var=True, block_b=32),
            inference.predict_batch(tcfg, ts, qi, TARGETS, return_var=True,
                                    block_b=32)):
        assert torch.equal(got, want)


def test_predict_routed_dispatch_and_empty_batch():
    _, tcfg, _, ts = _formed("exact", 2)
    qi = _joint(20, seed=24)[0][:, :FEATURES]
    assert torch.equal(
        inference.predict_batch_routed(tcfg, ts, qi, TARGETS, c=2),
        inference.predict_batch_sparse(tcfg, ts, qi, TARGETS, c=2))
    assert torch.equal(
        inference.predict_batch_routed(tcfg, ts, qi, TARGETS, c=0),
        inference.predict_batch(tcfg, ts, qi, TARGETS))
    assert inference.predict_batch_routed(tcfg, ts, qi[:0], TARGETS,
                                          c=2).shape == (0, CLASSES)
    with pytest.raises(ValueError, match="positive shortlist"):
        inference.predict_batch_sparse(tcfg, ts, qi, TARGETS, c=0)
    with pytest.raises(ValueError, match="positive shortlist"):
        shortlist.score_batch_sparse(tcfg, ts, torch.from_numpy(qi), c=0)


# ---------------------------------------------------------------------------
# the slice as a whole: runtime and Mixture against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "paper"])
def test_sparse_runtime_matches_reference(mode):
    x, _ = _joint(150, seed=1)
    q, _ = _joint(40, seed=2)
    jcfg, tcfg = _configs(x, kmax=8, shortlist_c=3, update_mode=mode)
    jrt = JStreamRuntime(jcfg, JRuntimeConfig(chunk=32))
    jrt.ingest(x)
    rt = StreamRuntime(tcfg, RuntimeConfig(chunk=32, device="cpu"))
    summary = rt.ingest(x)
    assert rt.path == jrt.path == "sparse"
    assert summary["total_points"] == 150
    _assert_states_close(rt.state, jrt.state)
    _close(rt.score(q), jrt.score(q), 1e-4)
    assert rt.score(q[:0]).shape == (0,)
    qi = q[:, :FEATURES]
    _close(rt.predict(qi, TARGETS), jrt.predict(qi, TARGETS), 1e-3)
    assert rt.factor_cache.misses == 1


def test_sparse_mixture_matches_reference():
    from repro.api import Mixture as JMixture
    from repro.api import MixtureSpec as JMixtureSpec
    x, y = _joint(150, seed=7)
    jcfg, tcfg = _configs(x, kmax=8, shortlist_c=3, update_mode="exact",
                          backend="pallas")
    jmix = JMixture(JMixtureSpec(model=jcfg,
                                 runtime=JRuntimeConfig(chunk=50)))
    jmix.partial_fit(x)
    mix = Mixture(MixtureSpec(model=tcfg,
                              runtime=RuntimeConfig(chunk=50, device="cpu")))
    mix.partial_fit(x)
    assert mix.read_shortlist_c == jmix.read_shortlist_c == 3
    assert "path='sparse'" in repr(mix) and "shortlist_c=3" in repr(mix)
    assert mix.n_active == jmix.n_active
    _close(mix.score_samples(x), jmix.score_samples(x), 1e-4)
    xi = x[:, :FEATURES]
    proba = mix.predict_proba(xi, TARGETS)
    _close(proba, jmix.predict_proba(xi, TARGETS), 1e-3)
    assert (proba.argmax(1).numpy() == y).mean() > 0.9
    dense = Mixture(MixtureSpec(model=tcfg, runtime=RuntimeConfig(
        chunk=50, path="scan", device="cpu")))
    assert dense.read_shortlist_c == 0
