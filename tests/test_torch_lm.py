"""The port's dense LM (``repro_torch.models``, ``repro_torch.serve``)
against the reference package on the CPU, at the danube-smoke size
(2 layers, d_model 64, 4 heads over 2 KV heads, float32, SWA window 8).

Parameters are made with numpy from a seed in the reference's tree layout
and carried into both packages (``interop.lm_params_from_numpy``); so are
tokens and activations.  Tolerances (float32 throughout): logits and
caches ``atol = 1e-5`` (both packages sum the same float32 terms in other
orders); layers ``atol = 1e-5`` or tighter as stated.  Greedy decoding is
compared token for token, and each step's top-2 logit margin must be at
least 100× the logits tolerance, so a near-tie cannot decide the test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data.tokens import SyntheticTokens as JaxTokens
from repro.data.tokens import TokenPipelineConfig as JaxTokenConfig
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import configs, interop
from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "h2o-danube-1.8b"
CFG_J = jax_configs.get_smoke(ARCH)
CFG_T = configs.get_smoke(ARCH)
LOGITS_ATOL = 1e-5


def _numpy_params(seed=0):
    """Seeded params in the reference's tree: weights N(0, 0.3²/fan_in),
    norm scales N(0, 0.1²) (so the 1 + scale form is exercised), the
    lm_head at 0.25 so the logits spread (std ≈ 2) well beyond the
    tolerance.  Weights at 1/√fan_in would sharpen attention enough to
    put the two packages' float32 logits 6e-5 apart; at 0.3/√fan_in they
    differ by 3.5e-6."""
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


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, CFG_J.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs, params, tokens
# ---------------------------------------------------------------------------

def test_configs_match_reference_field_for_field():
    for get in ("get", "get_smoke"):
        a = getattr(jax_configs, get)(ARCH)
        b = getattr(configs, get)(ARCH)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.n_params() == b.n_params()
        assert (a.q_per_kv, a.is_encdec) == (b.q_per_kv, b.is_encdec)
    assert configs.get(ARCH).param_dtype == torch.bfloat16
    assert set(configs.ARCH_IDS) == set(jax_configs.ARCH_IDS)
    for arch in configs.ARCH_IDS:
        if arch != ARCH:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                configs.get(arch)
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                configs.get_smoke(arch)


def test_init_params_have_the_reference_tree():
    mine = tt.init_params(CFG_T, seed=0, device="cpu")
    ref = jt.init_params(CFG_J, jax.random.PRNGKey(0))
    flat_ref = {jax.tree_util.keystr(p): x.shape for p, x in
                jax.tree_util.tree_leaves_with_path(ref)}
    flat_mine = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
                 jax.tree_util.tree_leaves_with_path(mine)}
    assert flat_mine == flat_ref
    assert tt.param_count(mine) == jt.param_count(ref)
    assert all(x.dtype == torch.float32
               for x in jax.tree_util.tree_leaves(mine))
    again = tt.init_params(CFG_T, seed=0, device="cpu")
    assert torch.equal(mine["blocks"]["attn"]["wq"],
                       again["blocks"]["attn"]["wq"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.init_params(dataclasses.replace(CFG_T, family="moe"),
                       device="cpu")


def test_bf16_params_travel_exactly():
    full = jax_configs.get(ARCH)
    small = dataclasses.replace(full, n_layers=1, d_model=32, d_ff=48,
                                vocab_size=64, n_heads=4, n_kv_heads=2,
                                head_dim=8)
    ref = jt.init_params(small, jax.random.PRNGKey(1))
    mine = interop.lm_params_from_numpy(jax.tree.map(np.asarray, ref),
                                        device="cpu")
    assert mine["embed"].dtype == torch.bfloat16
    back = interop.lm_params_to_numpy(mine)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("vocab,seq,batch,seed,step,hosts,host", [
    (256, 24, 2, 0, 0, 1, 0), (32000, 64, 4, 7, 3, 2, 1),
    (1000, 17, 3, 123, 11, 1, 0)])
def test_synthetic_tokens_match_reference(vocab, seq, batch, seed, step,
                                          hosts, host):
    a = JaxTokens(JaxTokenConfig(vocab, seq, batch, seed, hosts, host))
    b = SyntheticTokens(TokenPipelineConfig(vocab, seq, batch, seed, hosts,
                                            host))
    for k, v in a.batch(step).items():
        assert np.array_equal(v, b.batch(step)[k]), k


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 7, 4, 16)).astype(np.float32)
    scale = rng.normal(0, 0.3, (16,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6)
    pos = rng.integers(0, 8192, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          10000.0)),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 10000.0)), atol=1e-5)


@pytest.mark.parametrize("window,with_valid", [(0, False), (300, True)])
def test_chunked_attention_matches_reference(window, with_valid):
    """s = 1024 > ATTN_KV_CHUNK: two chunks of online softmax; GQA 4/2."""
    b, t, s, h, kv, hd = 2, 16, 1024, 4, 2, 16
    rng = np.random.default_rng(window)
    q = rng.normal(0, 1, (b, t, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kv, hd)).astype(np.float32)
    qp = np.broadcast_to(np.arange(s - t, s, dtype=np.int32), (b, t)).copy()
    kp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    valid = rng.random((b, s)) < 0.8 if with_valid else None
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(qp), jnp.asarray(kp), causal=True,
                        window=window,
                        k_valid=None if valid is None else jnp.asarray(valid))
    got = tl.attention(*(torch.from_numpy(a) for a in (q, k, v, qp, kp)),
                       causal=True, window=window,
                       k_valid=None if valid is None
                       else torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_embed_unembed_match_reference(act):
    rng = np.random.default_rng(1)
    d, f, vocab = 64, 96, 256
    x = rng.normal(0, 1, (2, 5, d)).astype(np.float32)
    w = [rng.normal(0, 0.1, s).astype(np.float32)
         for s in ((d, f), (d, f), (f, d))]
    np.testing.assert_allclose(
        _np(tl.gated_mlp(torch.from_numpy(x),
                         *map(torch.from_numpy, w), act)),
        np.asarray(jl.gated_mlp(jnp.asarray(x), *map(jnp.asarray, w), act)),
        atol=1e-5)
    table = rng.normal(0, 1, (vocab, d)).astype(np.float32)
    toks = rng.integers(0, vocab, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tl.embed(torch.from_numpy(toks), torch.from_numpy(table),
                     scale=True)),
        np.asarray(jl.embed(jnp.asarray(toks), jnp.asarray(table),
                            scale=True)))
    for tied, head in ((True, table), (False, np.ascontiguousarray(table.T))):
        np.testing.assert_allclose(
            _np(tl.unembed(torch.from_numpy(x), torch.from_numpy(head),
                           tied)),
            np.asarray(jl.unembed(jnp.asarray(x), jnp.asarray(head), tied)),
            atol=1e-5)


# ---------------------------------------------------------------------------
# the scoring path: forward_train / loss_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_train_and_loss_match_reference(params, attn_impl, impl):
    """T = 24 > window 8, so SWA masks; "flash" on the CPU runs the
    kernel's plain version on both sides."""
    pj, pt = params
    attn_impl(impl)
    toks = _tokens(2, 24, seed=5)
    tgt = np.roll(toks, -1, axis=1)
    mask = (np.random.default_rng(6).random((2, 24)) < 0.7) \
        .astype(np.float32)
    bj = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    bt = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt)}
    with torch.no_grad():
        got = tt.forward_train(pt, CFG_T, bt)
        loss = tt.loss_fn(pt, CFG_T, bt)
        loss_m = tt.loss_fn(pt, CFG_T, dict(bt, loss_mask=torch.from_numpy(
            mask)))
    np.testing.assert_allclose(_np(got), np.asarray(
        jt.forward_train(pj, CFG_J, bj)), atol=LOGITS_ATOL)
    assert abs(float(loss) - float(jt.loss_fn(pj, CFG_J, bj))) < 1e-5
    assert abs(float(loss_m) - float(jt.loss_fn(
        pj, CFG_J, dict(bj, loss_mask=jnp.asarray(mask))))) < 1e-5


def test_flash_and_plain_attention_agree_in_the_port(params, attn_impl):
    _, pt = params
    bt = {"tokens": torch.from_numpy(_tokens(1, 40, seed=8))}
    with torch.no_grad():
        attn_impl("flash")
        a = tt.forward_train(pt, CFG_T, bt)
        attn_impl("xla")
        b = tt.forward_train(pt, CFG_T, bt)
    np.testing.assert_allclose(_np(a), _np(b), atol=LOGITS_ATOL)


# ---------------------------------------------------------------------------
# the generation path: prefill / decode_step / ServeEngine
# ---------------------------------------------------------------------------

def _assert_cache_close(cj, ct):
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(ct["kv"][name]),
                                   np.asarray(cj["kv"][name]),
                                   atol=LOGITS_ATOL, err_msg=name)
    np.testing.assert_array_equal(_np(ct["kv"]["pos"]),
                                  np.asarray(cj["kv"]["pos"]))
    np.testing.assert_array_equal(_np(ct["idx"]), np.asarray(cj["idx"]))


@pytest.mark.parametrize("max_len,lengths", [
    (32, None),           # exact prefill, full cache
    (32, (5, 8)),         # masked prefill over end-padded rows
    (8, (6, 3)),          # ring buffer no longer than the window: decode
                          # wraps it and every layer takes the window
])
def test_prefill_and_decode_match_reference(params, max_len, lengths):
    pj, pt = params
    toks = _tokens(2, 8, seed=max_len)
    bj, bt = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks)}
    if lengths is not None:
        bj["lengths"] = jnp.asarray(lengths, jnp.int32)
        bt["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    cj = jt.init_cache(CFG_J, 2, max_len)
    ct = tt.init_cache(CFG_T, 2, max_len, device="cpu")
    with torch.no_grad():
        lt, ct = tt.prefill(pt, CFG_T, bt, ct)
    lj, cj = jt.prefill(pj, CFG_J, bj, cj)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=LOGITS_ATOL)
    _assert_cache_close(cj, ct)
    nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]
    for _ in range(6):
        with torch.no_grad():
            lt, ct = tt.decode_step(pt, CFG_T, torch.from_numpy(nxt), ct)
        lj, cj = jt.decode_step(pj, CFG_J, jnp.asarray(nxt), cj)
        np.testing.assert_allclose(_np(lt), np.asarray(lj),
                                   atol=LOGITS_ATOL)
        _assert_cache_close(cj, ct)
        nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]


def _recording_engine(pt, n_slots, max_len):
    """A port engine whose prefill/decode logits (of the active rows) are
    kept, for the near-tie guard."""
    eng = ServeEngine(CFG_T, pt, n_slots=n_slots, max_len=max_len,
                      device="cpu")
    seen = []
    prefill, decode = eng.prefill, eng.decode

    def rec_prefill(*a):
        out = prefill(*a)
        seen.append(out[0][0])
        return out

    def rec_decode(*a):
        out = decode(*a)
        seen.extend(out[0][i] for i, r in enumerate(eng.slot_req)
                    if r is not None)
        return out
    eng.prefill, eng.decode = rec_prefill, rec_decode
    return eng, seen


def _assert_no_near_tie(logits):
    for row in logits:
        top2 = torch.topk(row, 2).values
        assert float(top2[0] - top2[1]) >= 100 * LOGITS_ATOL


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG_J.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def test_engine_greedy_tokens_equal_reference(params):
    pj, pt = params
    prompts = _prompts((5, 7, 6, 11, 3), seed=0)
    eng_j = JaxEngine(CFG_J, pj, n_slots=2, max_len=32)
    eng_t, seen = _recording_engine(pt, 2, 32)
    reqs_j = [JaxRequest(rid=i, prompt=p, max_tokens=6)
              for i, p in enumerate(prompts)]
    reqs_t = [Request(rid=i, prompt=p, max_tokens=6)
              for i, p in enumerate(prompts)]
    for rj, rt in zip(reqs_j, reqs_t):
        eng_j.submit(rj)
        eng_t.submit(rt)
    eng_j.run(max_ticks=50)
    eng_t.run(max_ticks=50)
    _assert_no_near_tie(seen)
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.done and rj.done
        assert rt.out_tokens == rj.out_tokens, rt.rid


def test_bucketed_prompt_decodes_like_unbucketed(params):
    """Port against port, as tests/test_serve.py does for the reference:
    varied lengths go through power-of-two buckets (masked prefill) and
    still decode exactly like an exact-length prefill."""
    _, pt = params
    lengths = (3, 5, 6, 9, 13)
    prompts = _prompts(lengths, seed=2)
    eng, seen = _recording_engine(pt, 2, 48)
    assert [eng._prefill_bucket(s) for s in lengths] == [4, 8, 8, 16, 16]
    reqs = [Request(rid=i, prompt=p, max_tokens=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=100)
    _assert_no_near_tie(seen)
    for r in reqs:
        cache = tt.init_cache(CFG_T, 1, max_len=len(r.prompt) + 5,
                              device="cpu")
        with torch.no_grad():
            logits, cache = tt.prefill(
                pt, CFG_T, {"tokens": torch.from_numpy(r.prompt)[None]},
                cache)
            want = [int(torch.argmax(logits[0]))]
            for _ in range(3):
                logits, cache = tt.decode_step(
                    pt, CFG_T, torch.tensor([[want[-1]]], dtype=torch.int32),
                    cache)
                want.append(int(torch.argmax(logits[0])))
        assert r.out_tokens == want, (r.rid, r.out_tokens, want)
