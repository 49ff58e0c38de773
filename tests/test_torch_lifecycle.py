"""The port's mixture merging and pool lifecycle (``repro_torch.core.merge``,
``repro_torch.stream.lifecycle``, ``StreamRuntime`` with a
``LifecycleConfig``) against ``repro.core.merge`` / ``repro.stream`` on
the CPU.

Tolerances: merging inverts float32 precisions and covariances (O(D³), in
another library's LU), so moment-matched slots agree to rtol 1e-4 against
each slot's largest entry; everything a merge leaves alone, the choice of
pair, the active masks and every count are exact.  Runtimes are held as in
tests/test_torch_runtime.py: rtol/atol 1e-4 on the states (Λ relative to
its largest entry).  The reference's "vmem" path runs the Pallas kernel in
interpret mode, the port's the plain resident loop.  Port-vs-port
contracts (chunked ≡ one-shot with a lifecycle) are bit-exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import figmn as jfigmn
from repro.core import merge as jmerge
from repro.core.types import FIGMNConfig as JConfig
from repro.core.types import FIGMNState as JState
from repro.stream import LifecycleConfig as JLifecycleConfig
from repro.stream import RuntimeConfig as JRuntimeConfig
from repro.stream import StreamRuntime as JStreamRuntime
from repro.stream import lifecycle as jlifecycle
from repro_torch import interop
from repro_torch.api import Mixture, MixtureSpec
from repro_torch.core import figmn, merge
from repro_torch.core.types import FIGMNState
from repro_torch.stream import (FailureBuffer, LifecycleConfig,
                                RuntimeConfig, StreamRuntime, lifecycle)

FIELDS = interop.STATE_FIELDS


def _random_states(kmax, dim, k_active, seed):
    """tests/test_merge.py's state: k_active live slots with SPD
    precisions, as a (reference, port) pair built from one numpy draw."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(0, 5.0, (kmax, dim))
    a = rng.normal(0, 1.0, (kmax, dim, dim))
    cov = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(dim)
    active = np.zeros(kmax, bool)
    active[:k_active] = True
    arrays = {
        "mu": mu.astype(np.float32),
        "lam": np.linalg.inv(cov).astype(np.float32),
        "logdet": np.linalg.slogdet(cov)[1].astype(np.float32),
        "sp": np.where(active, rng.uniform(1.0, 20.0, kmax),
                       0.0).astype(np.float32),
        "v": np.where(active, rng.uniform(5.0, 40.0, kmax),
                      0.0).astype(np.float32),
        "active": active,
        "n_created": np.asarray(k_active, np.int32)}
    jstate = JState(**{f: jnp.asarray(arrays[f]) for f in FIELDS})
    return jstate, interop.state_from_numpy(arrays, "cpu")


def _configs(kmax, dim, **kw):
    base = dict(kmax=kmax, dim=dim, beta=0.1, delta=1.0, vmin=1e9,
                spmin=0.0, update_mode="exact", sigma_ini=1.0)
    base.update(kw)
    jcfg = JConfig(**base)
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return jcfg, interop.config_from_dict(d)


def _np(state):
    if isinstance(state, FIGMNState):
        return interop.state_to_numpy(state)
    return {f: np.array(getattr(state, f)) for f in FIELDS}


def _assert_states_close(got, want, tol=1e-4):
    g, w = _np(got), _np(want)
    assert int(g["n_created"]) == int(w["n_created"])
    np.testing.assert_array_equal(g["active"], w["active"])
    np.testing.assert_array_equal(g["v"], w["v"])
    act = w["active"]
    scale = float(np.abs(w["lam"][act]).max())
    np.testing.assert_allclose(g["lam"][act], w["lam"][act], rtol=tol,
                               atol=tol * scale)
    for f in ("mu", "logdet", "sp"):
        np.testing.assert_allclose(g[f][act], w[f][act], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# core.merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 21])
def test_closest_pair_picks_the_reference_pair(seed):
    jst, st = _random_states(10, 5, 7, seed)
    ia, ib = merge.closest_pair(st)
    ja, jb = jmerge.closest_pair(jst)
    assert (ia, ib) == (int(ja), int(jb)) and ia < ib


@pytest.mark.parametrize("ia,ib", [(1, 4), (5, 0)])
def test_moment_match_pair_matches_reference(ia, ib):
    jcfg, cfg = _configs(6, 4)
    jst, st = _random_states(6, 4, 6, seed=3)
    got = _np(merge.moment_match_pair(cfg, st, ia, ib))
    want = _np(jmerge.moment_match_pair(jcfg, jst, jnp.asarray(ia),
                                        jnp.asarray(ib)))
    np.testing.assert_array_equal(got["active"], want["active"])
    assert not got["active"][ib] and got["sp"][ib] == 0.0
    keep = [j for j in range(6) if j not in (ia, ib)]
    for f in ("mu", "lam", "logdet", "sp", "v"):
        np.testing.assert_array_equal(got[f][keep], want[f][keep])
    np.testing.assert_array_equal(got["v"], want["v"])
    scale = float(np.abs(want["lam"][ia]).max())
    np.testing.assert_allclose(got["lam"][ia], want["lam"][ia], rtol=1e-4,
                               atol=1e-4 * scale)
    for f in ("mu", "logdet", "sp"):
        np.testing.assert_allclose(got[f][ia], want[f][ia], rtol=1e-4,
                                   atol=1e-4)
    # the input state is left as it was
    np.testing.assert_array_equal(_np(st)["active"], np.ones(6, bool))


def test_union_conserves_mass_and_matches_reference():
    jcfg, cfg = _configs(8, 3)
    ja, a = _random_states(8, 3, 5, seed=1)
    jb, b = _random_states(8, 3, 3, seed=2)
    wide = dataclasses.replace(cfg, kmax=16)
    u = _np(merge.union(wide, [a, b]))
    want = _np(jmerge.union(dataclasses.replace(jcfg, kmax=16), [ja, jb]))
    for f in FIELDS:                       # a permutation: exact
        np.testing.assert_array_equal(u[f], want[f])
    sp_in = np.concatenate([_np(a)["sp"][:5], _np(b)["sp"][:3]])
    np.testing.assert_array_equal(np.sort(u["sp"][u["active"]]),
                                  np.sort(sp_in))
    assert int(u["n_created"]) == 8
    # truncation keeps the strongest slots, as the reference
    narrow = _np(merge.union(dataclasses.replace(cfg, kmax=4), [a, b]))
    want = _np(jmerge.union(dataclasses.replace(jcfg, kmax=4), [ja, jb]))
    for f in FIELDS:
        np.testing.assert_array_equal(narrow[f], want[f])


@pytest.mark.parametrize("budget", [6, 3, 1])
def test_merge_to_budget_matches_reference(budget):
    jcfg, cfg = _configs(10, 5)
    jst, st = _random_states(10, 5, 8, seed=4)
    got, n = merge.merge_to_budget(cfg, st, budget)
    want, jn = jmerge.merge_to_budget(jcfg, jst, budget)
    assert n == jn == 8 - budget
    assert int(got.n_active) == budget
    _assert_states_close(got, want)
    g = _np(got)
    np.testing.assert_allclose(g["sp"].sum(), _np(st)["sp"].sum(),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# stream.lifecycle
# ---------------------------------------------------------------------------

def test_failure_buffer_matches_reference():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(11, 3)).astype(np.float32)
    got, want = FailureBuffer(8, 3), jlifecycle.FailureBuffer(8, 3)
    for buf in (got, want):
        buf.push(xs[:5])
        buf.push(xs[5])
        buf.push(xs[6:])                       # over capacity: oldest go
    assert len(got) == len(want) == 8
    e, je = got.export_state(), want.export_state()
    np.testing.assert_array_equal(e["buf"], je["buf"])
    assert int(e["count"]) == int(je["count"]) == 8
    np.testing.assert_array_equal(got.drain(3), want.drain(3))
    back = FailureBuffer(8, 3)
    back.load_state(got.export_state())
    np.testing.assert_array_equal(back.drain(), want.drain())
    assert FailureBuffer.state_template(8, 3)["buf"].shape == (8, 3)
    off = FailureBuffer(0, 3)
    off.push(xs)
    assert len(off) == 0 and off.drain().shape == (0, 3)


def _formed(seed, n=120, d=4, **kw):
    """A pool formed by the reference scan over three clusters, plus the
    stream, as (jcfg, cfg, jstate, state, x)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 8.0, (4, d))
    x = (centers[rng.integers(0, 4, n)]
         + rng.normal(0, 1.0, (n, d))).astype(np.float32)
    sigma = np.asarray(jfigmn.sigma_from_data(jnp.asarray(x), 1.0))
    jcfg, cfg = _configs(8, d, sigma_ini=sigma, **kw)
    jcfg = dataclasses.replace(jcfg, sigma_ini=jnp.asarray(sigma))
    jst = jfigmn.fit(jcfg, jfigmn.init_state(jcfg), jnp.asarray(x[:90]),
                     do_prune=False)
    st = interop.state_from_numpy(_np(jst), "cpu")
    return jcfg, cfg, jst, st, x


@pytest.mark.parametrize("lcfg", [
    dict(k_budget=3, spawn_max=4),
    dict(k_budget=0, spawn_max=2, merge_down=False),
    dict(k_budget=2, spawn_max=8, prune=False),
])
def test_run_pass_matches_reference(lcfg):
    jcfg, cfg, jst, st, x = _formed(5, vmin=20.0, spmin=4.0)
    far = x[90:96] + 40.0                      # fail every gate: spawns
    jbuf, buf = jlifecycle.FailureBuffer(16, 4), FailureBuffer(16, 4)
    jbuf.push(far)
    buf.push(far)
    got, rep = lifecycle.run_pass(cfg, LifecycleConfig(**lcfg), st, buf)
    want, jrep = jlifecycle.run_pass(jcfg, JLifecycleConfig(**lcfg), jst,
                                     jbuf)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.spawned == min(lcfg["spawn_max"], 6)
    assert rep.pruned > 0 or not lcfg.get("prune", True)
    assert rep.merged > 0 or not lcfg.get("merge_down", True)
    assert len(buf) == len(jbuf)
    _assert_states_close(got, want)


# ---------------------------------------------------------------------------
# StreamRuntime with a lifecycle
# ---------------------------------------------------------------------------

def _stream(n, d, modes, seed):
    """benchmarks/figmn_runtime.py's stream: seeded clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 6.0, (modes, d))
    x = centers[rng.integers(0, modes, n)] + rng.normal(0, 1.0, (n, d))
    return x.astype(np.float32)


def _runtime_configs(x, k, **kw):
    sigma = np.asarray(jfigmn.sigma_from_data(jnp.asarray(x), 1.0))
    jcfg, cfg = _configs(k, x.shape[1], vmin=50.0, spmin=1.0,
                         sigma_ini=sigma, **kw)
    return dataclasses.replace(jcfg, sigma_ini=jnp.asarray(sigma)), cfg


@pytest.mark.parametrize("path", ["scan", "vmem"])
def test_runtime_with_lifecycle_matches_reference(path):
    """figmn_runtime's cell at fixture scale: the lifecycle every 2 chunks
    under a budget below the stream's modes, so the passes prune, spawn
    (on "vmem", from the buffered gate failures) and merge."""
    x = _stream(192, 6, 8, seed=3)
    jcfg, cfg = _runtime_configs(x, 8)
    kw = dict(k_budget=3, every=2, spawn_max=4)
    jrt = JStreamRuntime(jcfg, JRuntimeConfig(
        chunk=32, path=path, lifecycle=JLifecycleConfig(**kw)))
    jsum = jrt.ingest(x)
    rt = StreamRuntime(cfg, RuntimeConfig(
        chunk=32, path=path, lifecycle=LifecycleConfig(**kw),
        device="cpu"))
    summary = rt.ingest(x)
    for key in ("chunks", "total_points", "active_k", "created", "pruned",
                "merged", "spawned", "accepted"):
        assert summary[key] == jsum[key], key
    assert summary["merged"] > 0
    if path == "vmem":
        assert summary["spawned"] > 0 and summary["accepted"] > 0
    assert [m.path for m in rt.telemetry.history] \
        == [m.path for m in jrt.telemetry.history]
    assert [(m.pruned, m.merged, m.spawned) for m in rt.telemetry.history] \
        == [(m.pruned, m.merged, m.spawned) for m in jrt.telemetry.history]
    _assert_states_close(rt.state, jrt.state)
    np.testing.assert_allclose(rt.score(x[:40]).numpy(),
                               np.asarray(jrt.score(x[:40])), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("path", ["scan", "vmem"])
def test_lifecycle_chunked_equals_one_shot(path):
    """Split at lifecycle boundaries (and with spawn_max draining the whole
    buffer), several ``ingest`` calls equal one: the end-of-call pass then
    finds nothing left to do.  Bit-exact, port against port."""
    x = _stream(192, 6, 8, seed=4)
    _, cfg = _runtime_configs(x, 8)
    rc = RuntimeConfig(chunk=32, path=path, device="cpu",
                       lifecycle=LifecycleConfig(k_budget=3, every=2,
                                                 spawn_max=256))
    one = StreamRuntime(cfg, rc)
    one.ingest(x)
    parts = StreamRuntime(cfg, rc)
    for a in (0, 64, 128):
        parts.ingest(x[a:a + 64])
    for f in FIELDS:
        assert torch.equal(getattr(parts.state, f), getattr(one.state, f)), f
    s1, s2 = one.telemetry.summary(), parts.telemetry.summary()
    for key in ("chunks", "created", "pruned", "merged", "spawned",
                "accepted"):
        assert s1[key] == s2[key], key


def test_lifecycle_off_keeps_inline_pruning_and_one_shot_fit():
    """No lifecycle: the runtime is still one ``figmn.fit`` with inline
    pruning, and the lifecycle counters stay 0."""
    x = _stream(160, 5, 4, seed=5)
    _, cfg = _runtime_configs(x, 8)
    rt = StreamRuntime(cfg, RuntimeConfig(chunk=40, device="cpu"))
    summary = rt.ingest(x)
    want = figmn.fit(cfg, figmn.init_state(cfg, "cpu"), torch.from_numpy(x))
    for f in FIELDS:
        assert torch.equal(getattr(rt.state, f), getattr(want, f)), f
    assert summary["pruned"] == summary["merged"] == summary["spawned"] == 0


def test_mixture_passes_the_lifecycle_through():
    x = _stream(128, 5, 6, seed=6)
    _, cfg = _runtime_configs(x, 8)
    rc = RuntimeConfig(chunk=32, path="vmem", device="cpu",
                       lifecycle=LifecycleConfig(k_budget=3, every=2))
    mix = Mixture(MixtureSpec(model=cfg, runtime=rc)).partial_fit(x)
    rt = StreamRuntime(cfg, rc)
    rt.ingest(x)
    assert mix.n_active == int(rt.state.n_active) <= 3
    assert mix.summary() == {**rt.telemetry.summary(),
                             "points_per_s": mix.summary()["points_per_s"]}
    for f in FIELDS:
        assert torch.equal(getattr(mix.state, f), getattr(rt.state, f)), f
