"""The port's stream runtime and Mixture (``repro_torch.stream``,
``repro_torch.api``) against ``repro.stream`` / ``repro.api`` on the CPU.

The reference runs with lifecycle, drift and checkpoints off (the port's
slice has none of them); its "vmem" path runs the Pallas kernel in
interpret mode, the port's runs the plain resident loop.  Tolerances as in
tests/test_torch_figmn.py: rtol/atol 1e-4 on states and scores (Λ relative
to its largest entry), 1e-3 on eq. 27 reads, whose o×o solves and Schur
complements amplify the state's ulp-level differences.  Port-vs-port
contracts (chunked ≡ one-shot, cached ≡ uncached, drop ≡ never seen) are
bit-exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Mixture as JMixture
from repro.api import MixtureSpec as JMixtureSpec
from repro.core import figmn as jfigmn
from repro.core.types import FIGMNConfig as JConfig
from repro.core import inference as jinference
from repro.core.types import chi2_quantile as jchi2
from repro.stream import ingest as jingest
from repro.stream import RuntimeConfig as JRuntimeConfig
from repro.stream import StreamRuntime as JStreamRuntime
from repro_torch import interop
from repro_torch.api import Mixture, MixtureSpec, to_proba
from repro_torch.core import figmn, inference
from repro_torch.stream import ingest
from repro_torch.core.types import gate_threshold
from repro_torch.stream import (DoubleBufferedLoader, NonFiniteChunkError,
                                RuntimeConfig, StreamRuntime, select_path)

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


def _configs(x, **kw):
    sigma = np.asarray(jfigmn.sigma_from_data(jnp.asarray(x), 1.0))
    jcfg = JConfig(dim=x.shape[1], delta=1.0, sigma_ini=jnp.asarray(sigma),
                   **kw)
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["sigma_ini"] = sigma
    tcfg = interop.config_from_dict(d)
    assert gate_threshold(tcfg) == float(jchi2(tcfg.dim, 1.0 - tcfg.beta))
    return jcfg, tcfg


def _assert_states_close(got, want, tol=1e-4):
    g = interop.state_to_numpy(got)
    w = {f: np.array(getattr(want, f)) for f in interop.STATE_FIELDS}
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


@pytest.mark.parametrize("path", ["scan", "vmem"])
def test_runtime_matches_reference(path):
    x, _ = _joint(150, seed=1)
    q, _ = _joint(40, seed=2)
    jcfg, tcfg = _configs(x, kmax=6, beta=0.1, update_mode="exact",
                          vmin=1e9, spmin=0.0)
    jrt = JStreamRuntime(jcfg, JRuntimeConfig(chunk=32, path=path))
    jrt.ingest(x)
    rt = StreamRuntime(tcfg, RuntimeConfig(chunk=32, path=path,
                                           device="cpu"))
    summary = rt.ingest(x)
    assert rt.path == path and summary["total_points"] == 150
    assert summary["accepted"] == jrt.telemetry.summary()["accepted"]
    _assert_states_close(rt.state, jrt.state)
    _close(rt.score(q), jrt.score(q), 1e-4)
    qi = q[:, :FEATURES]
    _close(rt.predict(qi, TARGETS), jrt.predict(qi, TARGETS), 1e-3)
    mean, var = rt.predict(qi, TARGETS, return_var=True)
    jmean, jvar = jrt.predict(qi, TARGETS, return_var=True)
    _close(mean, jmean, 1e-3)
    _close(var, jvar, 1e-3)


def test_runtime_vmem_counts_accepts_on_device_and_falls_back_to_scan():
    x, _ = _joint(96, seed=3)
    _, tcfg = _configs(x, kmax=6, beta=0.1, update_mode="exact",
                       vmin=1e9, spmin=0.0)
    rt = StreamRuntime(tcfg, RuntimeConfig(chunk=32, path="vmem",
                                           device="cpu"))
    rt.ingest(x)
    paths = [m.path for m in rt.telemetry.history]
    assert paths == ["scan", "vmem", "vmem"]   # no slot yet: first is scan
    assert 0 < rt.telemetry.total_accepted <= 64


@pytest.mark.parametrize("path", ["scan", "vmem"])
def test_chunked_ingest_equals_one_shot(path):
    """Chunking re-slices the stream and never changes the math: bit-exact
    against one ``fit`` (scan) and across calls and chunk sizes."""
    x, _ = _joint(130, seed=4)
    _, tcfg = _configs(x, kmax=6, beta=0.1, update_mode="exact")
    if path == "scan":
        want = figmn.fit(tcfg, figmn.init_state(tcfg, "cpu"),
                         torch.from_numpy(x))
    else:
        ref = StreamRuntime(tcfg, RuntimeConfig(chunk=32, path=path,
                                                device="cpu"))
        ref.ingest(x)
        want = ref.state
    rt = StreamRuntime(tcfg, RuntimeConfig(chunk=32, path=path,
                                           device="cpu"))
    rt.ingest(x[:64])
    rt.ingest(x[64:])
    for f in interop.STATE_FIELDS:
        assert torch.equal(getattr(rt.state, f), getattr(want, f)), f
    if path == "scan":
        rt7 = StreamRuntime(tcfg, RuntimeConfig(chunk=7, path=path,
                                                device="cpu"))
        rt7.ingest(x)
        for f in interop.STATE_FIELDS:
            assert torch.equal(getattr(rt7.state, f), getattr(want, f)), f


def test_predict_cached_equals_uncached_and_cache_follows_epoch():
    x, _ = _joint(120, seed=5)
    _, tcfg = _configs(x, kmax=6, beta=0.1, update_mode="exact")
    rt = StreamRuntime(tcfg, RuntimeConfig(chunk=40, device="cpu"))
    rt.ingest(x[:80])
    qi = x[:50, :FEATURES]
    first = rt.predict(qi, TARGETS)
    again = rt.predict(qi, TARGETS)
    assert rt.factor_cache.hits == 1 and rt.factor_cache.misses == 1
    assert torch.equal(first, again)
    assert torch.equal(first, inference.predict_batch(tcfg, rt.state, qi,
                                                      TARGETS))
    # blocking the batch stage never changes a row
    assert torch.equal(first, inference.predict_batch(tcfg, rt.state, qi,
                                                      TARGETS, block_b=512))
    torch.testing.assert_close(
        inference.predict_batch(tcfg, rt.state, qi, TARGETS, block_b=16),
        first, rtol=1e-6, atol=1e-6)
    rt.ingest(x[80:])
    rt.predict(qi, TARGETS)
    assert rt.factor_cache.misses == 2        # a new epoch misses


def test_nonfinite_rows_dropped_equal_never_seen():
    x, _ = _joint(90, seed=6)
    _, tcfg = _configs(x, kmax=6, beta=0.1, update_mode="exact")
    poisoned = x.copy()
    poisoned[[5, 40, 41], 2] = np.nan
    clean = np.delete(x, [5, 40, 41], axis=0)
    a = StreamRuntime(tcfg, RuntimeConfig(chunk=30, device="cpu"))
    a.ingest(poisoned)
    b = StreamRuntime(tcfg, RuntimeConfig(chunk=30, device="cpu"))
    b.ingest(clean)
    assert a.telemetry.total_quarantined == 3
    for f in interop.STATE_FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    strict = StreamRuntime(tcfg, RuntimeConfig(chunk=30, device="cpu",
                                               on_nonfinite="raise"))
    with pytest.raises(NonFiniteChunkError):
        strict.ingest(poisoned)


def test_mixture_runtime_tier_matches_reference():
    x, y = _joint(150, seed=7)
    jcfg, tcfg = _configs(x, kmax=6, beta=0.1, update_mode="exact")
    jmix = JMixture(JMixtureSpec(model=jcfg,
                                 runtime=JRuntimeConfig(chunk=50)))
    jmix.partial_fit(x)
    mix = Mixture(MixtureSpec(model=tcfg,
                              runtime=RuntimeConfig(chunk=50, device="cpu")))
    assert mix.partial_fit(x[:100]) is mix
    mix.partial_fit(x[100:])
    assert mix.n_active == jmix.n_active
    _close(mix.score_samples(x), jmix.score_samples(x), 1e-4)
    xi = x[:, :FEATURES]
    proba = mix.predict_proba(xi, TARGETS)
    _close(proba, jmix.predict_proba(xi, TARGETS), 1e-3)
    torch.testing.assert_close(proba.sum(1), torch.ones(150))
    assert torch.equal(proba, to_proba(mix.predict(xi, TARGETS)))
    assert (proba.argmax(1).numpy() == y).mean() > 0.9
    assert mix.summary()["total_points"] == 150


def test_chunk_stats_and_single_predict_match_reference():
    x, _ = _joint(120, seed=13)
    jcfg, tcfg = _configs(x, kmax=6, beta=0.1, update_mode="exact")
    js = jfigmn.fit(jcfg, jfigmn.init_state(jcfg), jnp.asarray(x[:100]))
    ts = interop.state_from_numpy(
        {f: np.array(getattr(js, f)) for f in interop.STATE_FIELDS}, "cpu")
    q = x[100:]
    thresh = gate_threshold(tcfg)
    jfails, jll = jingest.chunk_stats(jcfg, js, jnp.asarray(q),
                                      jnp.float32(thresh))
    fails, ll = ingest.chunk_stats(tcfg, ts, torch.from_numpy(q), thresh)
    np.testing.assert_array_equal(fails.numpy(), np.asarray(jfails))
    _close(ll, jll, 1e-5)
    _close(inference.predict(tcfg, ts, q[0, :FEATURES], TARGETS),
           jinference.predict(jcfg, js, jnp.asarray(q[0, :FEATURES]),
                              TARGETS), 1e-4)


def test_empty_mixture_raises():
    x, _ = _joint(10, seed=8)
    _, tcfg = _configs(x, kmax=4)
    mix = Mixture(MixtureSpec(model=tcfg,
                              runtime=RuntimeConfig(device="cpu")))
    with pytest.raises(ValueError, match="empty mixture"):
        mix.predict(x[:, :FEATURES], TARGETS)
    with pytest.raises(ValueError, match="empty mixture"):
        mix.predict_proba(x[:, :FEATURES], TARGETS)


def test_unported_parts_raise():
    x, _ = _joint(10, seed=9)
    _, tcfg = _configs(x, kmax=4)
    for tier in ("fleet", "autoscaled"):
        with pytest.raises(NotImplementedError):
            Mixture(MixtureSpec(model=tcfg, tier=tier,
                                runtime=RuntimeConfig(device="cpu")))
    mix = Mixture(MixtureSpec(model=tcfg,
                              runtime=RuntimeConfig(device="cpu")))
    for call in (lambda: mix.sample(4), mix.save,
                 lambda: Mixture.load(mix.spec)):
        with pytest.raises(NotImplementedError):
            call()


def test_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _ = _joint(10, seed=10)
    _, tcfg = _configs(x, kmax=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamRuntime(tcfg, RuntimeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mixture(MixtureSpec(model=tcfg))


def test_select_path_resident_budget():
    """The resident kernels are chosen on CUDA only, in exact mode, within
    the reference's 12 MiB budget and what the card holds: one block for a
    pool that fits one, a cooperative grid beyond it (the per-block shared
    memory and the co-resident block count are passed here; queried on a
    card)."""
    h100 = dict(smem_limit=232448, max_blocks=132)
    x, _ = _joint(10, seed=11)
    _, cfg = _configs(x, kmax=16, update_mode="exact")
    small = dataclasses.replace(cfg, kmax=16, dim=32)
    big = dataclasses.replace(cfg, kmax=32, dim=64)      # 512 KiB: a grid
    over = dataclasses.replace(cfg, kmax=49, dim=256)    # 12.25 MiB
    assert select_path(small, device="cuda", **h100) == "vmem"
    assert select_path(small, device="cpu") == "scan"
    assert select_path(dataclasses.replace(small, update_mode="paper"),
                       device="cuda", **h100) == "scan"
    assert select_path(big, device="cuda", **h100) == "vmem"
    assert select_path(big, device="cuda", vmem_budget=2 ** 19 - 1,
                       **h100) == "scan"
    assert select_path(over, device="cuda", **h100) == "scan"
    assert select_path(over, requested="vmem", device="cuda",
                       **h100) == "vmem"
    # a card that holds two blocks cannot hold the big pool
    assert select_path(big, device="cuda", smem_limit=232448,
                       max_blocks=2) == "scan"
    with pytest.raises(ValueError, match="cannot hold"):
        select_path(big, requested="vmem", device="cuda",
                    smem_limit=232448, max_blocks=2)
    with pytest.raises(ValueError, match="exact"):
        select_path(dataclasses.replace(small, update_mode="paper"),
                    requested="vmem", device="cpu")
    assert select_path(big, requested="scan", device="cuda") == "scan"
    with pytest.raises(ValueError, match="unknown path"):
        select_path(small, requested="fast", device="cpu")


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 512, 1024, 1773])
def test_select_path_matches_reference_tpu_routing(d):
    """Around the reference's 12 MiB boundary (K·D²·4 exactly 12 MiB, one
    component more and one less, and a few small pools), the port on
    "cuda" with an H100's capacities picks "vmem" iff the reference's
    heuristic does on a TPU."""
    x, _ = _joint(10, seed=14)
    _, cfg = _configs(x, kmax=4, update_mode="exact")
    edge = jingest.DEFAULT_VMEM_BUDGET // (4 * d * d)
    ks = sorted({1, 2, 8, max(1, edge - 1), edge, edge + 1})
    assert ingest.DEFAULT_VMEM_BUDGET == jingest.DEFAULT_VMEM_BUDGET
    for k in ks:
        for mode in ("exact", "paper"):
            c = dataclasses.replace(cfg, kmax=k, dim=d, update_mode=mode,
                                    sigma_ini=None)
            jc = JConfig(kmax=k, dim=d, update_mode=mode)
            want = jingest.select_path(jc, device="tpu")
            got = select_path(c, device="cuda", smem_limit=232448,
                              max_blocks=132)
            assert got == want, (k, d, mode)
    assert select_path(dataclasses.replace(cfg, kmax=edge, dim=d,
                                           sigma_ini=None),
                       device="cuda", smem_limit=232448,
                       max_blocks=132) == "vmem"


def test_loader_yields_stream_in_chunks():
    x, _ = _joint(70, seed=12)
    loader = DoubleBufferedLoader(x, 32, "cpu")
    parts = list(loader)
    assert len(loader) == 3 and [p[0].shape[0] for p in parts] == [32, 32, 6]
    assert torch.equal(torch.cat([p[0] for p in parts]), torch.from_numpy(x))
    with pytest.raises(ValueError):
        DoubleBufferedLoader(x[0], 8, "cpu")
