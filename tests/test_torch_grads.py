"""The port's LM loss gradient (``repro_torch.train.trainer._grads`` and
``_accumulated_grads``) against the reference's
``jax.value_and_grad(repro.models.transformer.loss_fn)`` on the CPU, at
danube-smoke (2 layers, d_model 64, 4 heads over 2 KV heads, float32,
SWA window 8) with T = 24 > the window, under both ``ATTN_IMPL`` values
("flash" runs the reference's Pallas kernels in interpret mode and the
port's plain versions through its ``FlashAttention`` Function).

Parameters and tokens are made with numpy from a seed in the reference's
tree (tests/test_torch_lm.py's scheme) and carried into both packages;
the port's gradients come back through ``interop.lm_params_to_numpy``.
Tolerance per leaf: ``|g_port − g_ref| ≤ 1e-5 · max|g_ref|`` of that
leaf — both sides sum the same float32 terms in other orders (about
√n·2⁻²⁴ of the terms' scale, n ≤ 2·24·96 per entry).  Measured worst
(jax 0.9.0, CPU): 1.7e-6 of the leaf's largest entry.  The loss within
``atol = 1e-5`` (tests/test_torch_lm.py's).

Port against port, bit for bit: per-layer remat on ≡ off, and the
no-grad forward ≡ the loop as it ran before remat and the autograd
Function existed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.train import trainer as jtrain
from repro_torch import configs, interop
from repro_torch.core.types import map_tree
from repro_torch.kernels import flash_attention
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.train import trainer

ARCH = "h2o-danube-1.8b"
CFG_J = jax_configs.get_smoke(ARCH)
CFG_T = configs.get_smoke(ARCH)
LEAF_RTOL = 1e-5
LOSS_ATOL = 1e-5


def _numpy_params(seed=0):
    """tests/test_torch_lm.py's seeded params in the reference's tree."""
    rng = np.random.default_rng(seed)

    def leaf(path, d):
        shape = d["shape"]
        if d["kind"] == "zeros":
            return rng.normal(0, 0.1, shape).astype(np.float32)
        std = 0.25 if path == "lm_head" else \
            0.3 / np.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
        return rng.normal(0, std, shape).astype(np.float32)

    def walk(defs, path=""):
        if "shape" in defs and "axes" in defs:
            return leaf(path, defs)
        return {k: walk(v, k if not path else f"{path}.{k}")
                for k, v in defs.items()}
    return walk(jt.param_defs(CFG_J))


@pytest.fixture(scope="module")
def params():
    tree = _numpy_params()
    return (jax.tree.map(jnp.asarray, tree),
            interop.lm_params_from_numpy(tree, device="cpu"))


@pytest.fixture
def attn_impl():
    """Sets ATTN_IMPL on both sides; restores the default afterwards."""
    def set_(impl):
        jl.ATTN_IMPL = tl.ATTN_IMPL = impl
    yield set_
    set_("xla")


def _batch(b=2, s=24, seed=5, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG_T.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _assert_grads_close(got, want):
    """Every leaf of the port's grads (a torch tree) within LEAF_RTOL of
    the reference's largest entry of that leaf."""
    got = dict(_paths(interop.lm_params_to_numpy(got)))
    want = dict(_paths(jax.tree.map(np.asarray, want)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(got[name] - w).max())
        assert err <= LEAF_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_grads_match_reference(params, attn_impl, impl, with_mask):
    pj, pt = params
    attn_impl(impl)
    bj, bt = _batch(mask=with_mask)
    loss_j, g_j = jax.value_and_grad(
        lambda p: jt.loss_fn(p, CFG_J, bj))(pj)
    loss_t, g_t = trainer._grads(CFG_T, pt, bt)
    assert loss_t.dtype == torch.float32 and loss_t.grad_fn is None
    assert abs(float(loss_t) - float(loss_j)) < LOSS_ATOL
    _assert_grads_close(g_t, g_j)
    assert all(not t.requires_grad for _, t in _paths(g_t))
    assert all(not t.requires_grad for _, t in _paths(pt))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_accumulated_grads_match_reference(params, attn_impl, impl):
    pj, pt = params
    attn_impl(impl)
    bj, bt = _batch(b=4, seed=7, mask=True)
    loss_j, g_j = jtrain._accumulated_grads(CFG_J, pj, bj, 2)
    loss_t, g_t = trainer._accumulated_grads(CFG_T, pt, bt, 2)
    assert abs(float(loss_t) - float(loss_j)) < LOSS_ATOL
    _assert_grads_close(g_t, g_j)
    # the sum of the two microbatches' own gradients, scaled by 1/2
    halves = [trainer._grads(CFG_T, pt, {k: v[i:i + 2] for k, v in
                                         bt.items()}) for i in (0, 2)]
    assert torch.equal(loss_t, (halves[0][0] + halves[1][0]) * 0.5)
    want = map_tree(lambda a, b: (a + b) * 0.5, halves[0][1], halves[1][1])
    for (_, a), (_, b) in zip(_paths(g_t), _paths(want)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="microbatches"):
        trainer._accumulated_grads(CFG_T, pt, bt, 3)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_on_equals_off(params, attn_impl, impl, monkeypatch):
    """Per-layer recomputation changes no bit of the loss or the grads."""
    _, pt = params
    attn_impl(impl)
    _, bt = _batch(seed=9, mask=True)
    loss_on, g_on = trainer._grads(CFG_T, pt, bt)
    scan = tt._scan_blocks
    monkeypatch.setattr(tt, "_scan_blocks",
                        functools.partial(scan, remat=False))
    loss_off, g_off = trainer._grads(CFG_T, pt, bt)
    assert torch.equal(loss_on, loss_off)
    for (name, a), (_, b) in zip(_paths(g_on), _paths(g_off)):
        assert torch.equal(a, b), name


def _forward_before(params, cfg, batch):
    """forward_train as the port ran it before remat and the Function: the
    layers indexed one by one, flash attention straight from flash_fwd."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    x = tt._embed_inputs(params, cfg, tokens)
    wins = tt.layer_windows(cfg)
    for i in range(cfg.n_layers):
        x = tt._decoder_block(map_tree(lambda t: t[i], params["blocks"]), x,
                              pos, cfg, int(wins[i]))
    return tt._logits(params, cfg, x)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_no_grad_forward_and_loss_are_unchanged(params, attn_impl, impl,
                                                monkeypatch):
    """Under no_grad the forward is bit for bit the loop it was before
    (flash through ``flash_fwd`` directly), and ``loss_fn`` with gradients
    on (remat, the Function) gives the no-grad loss bit for bit."""
    _, pt = params
    attn_impl(impl)
    _, bt = _batch(seed=11, mask=True)
    with torch.no_grad():
        logits = tt.forward_train(pt, CFG_T, bt)
        loss = tt.loss_fn(pt, CFG_T, bt)
        with monkeypatch.context() as m:
            m.setattr(flash_attention, "flash_attention",
                      lambda q, k, v, qp, kp, w, causal=True:
                      flash_attention.flash_fwd(q, k, v, qp, kp, w,
                                                causal)[0])
            before = _forward_before(pt, CFG_T, bt)
    assert torch.equal(logits, before)
    loss_g, _ = trainer._grads(CFG_T, pt, bt)
    assert torch.equal(loss_g, loss)


def test_grads_travel_as_the_reference_tree(params):
    _, pt = params
    _, bt = _batch(seed=13)
    _, g = trainer._grads(CFG_T, pt, bt)
    tree = dict(_paths(interop.lm_params_to_numpy(g)))
    want = dict(_paths(_numpy_params()))
    assert tree.keys() == want.keys()
    for name, a in tree.items():
        assert a.shape == want[name].shape and a.dtype == np.float32, name
    for (name, a), (_, p) in zip(_paths(g), _paths(pt)):
        assert a.shape == p.shape and a.dtype == p.dtype, name
