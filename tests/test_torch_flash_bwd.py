"""The port's flash-attention backward (plain versions
``ref.flash_bwd_dq_ref`` / ``flash_bwd_dkv_ref`` and the CPU route of the
``FlashAttention`` autograd Function) against the reference's own backward:
``jax.vjp`` of the Pallas ``flash_attention`` in interpret mode
(``block_q = block_k = 16``) on tests/test_flash_attention.py's cases plus
head_dim 80 ragged and windowed; for GQA, ``jax.vjp`` of the reference's
``layers.attention_trainpath`` under ``ATTN_IMPL = "flash"``, which
expands k and v to the query heads and sums the group through autodiff.

Tolerances: float32 ``atol = 2e-5``, the reference's own flash-gradient
tolerance (tests/test_flash_attention.py).  bfloat16: per row,
‖got − want‖ ≤ 2⁻⁶·‖want‖ + 2⁻⁸·max‖want‖ (the largest row of that
output): both sides compute in float32 from the same bf16 operands and
round once, so a row moves by a few bf16 roundings (2⁻⁸ each) of its
norm; the floor covers rows whose terms cancel (a row with one visible
key has ds = p·(dp − δ) = 0 up to rounding).  Measured worst row (jax
0.9.0, CPU): 2.3e-4 of its norm for the plain backward fed the
reference's out, 4.0e-3 for the Function, whose own forward's out (p
rounded against another running max) moves δ; at most 0.16 of the limit.
The wrong backwards below land 48-51× over it.  Each limit is shown to fail
three wrong backwards: dq with one 64-key tile dropped, dk and dv with
one 64-row query tile dropped, and dk and dv that sum only the first
query head of each group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import layers as jax_layers
from repro_torch.kernels import _build, flash_attention, ref
from repro_torch.models import layers as torch_layers

CASES = [
    # (B, T, S, H, d, causal, window) — tests/test_flash_attention.py's
    (2, 32, 32, 2, 16, True, 0),
    (1, 48, 48, 3, 8, True, 10),
    (2, 16, 64, 2, 8, True, 0),          # cross-length
    (1, 33, 65, 2, 16, False, 0),        # ragged, non-causal
    (1, 40, 40, 1, 32, True, 4),         # tight window
    # head_dim 80 (h2o-danube-1.8b), ragged cross-length, windowed
    (1, 37, 70, 2, 80, True, 16),
]
# (B, T, S, H, KV, d, causal, window): GQA, two and three query heads a group
GQA_CASES = [
    (1, 37, 70, 4, 2, 80, True, 16),
    (2, 24, 24, 6, 2, 16, True, 0),
]
ATOL = 2e-5
BF16_ROW, BF16_FLOOR = 2.0 ** -6, 2.0 ** -8


def _mk(case, seed=0, kv=None):
    """q, k, v, q_pos, k_pos, dout as numpy (k, v at ``kv`` heads)."""
    b, t, s, h, d = case[:5]
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kv or h, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kv or h, d)).astype(np.float32)
    qp = np.broadcast_to(np.arange(s - t, s, dtype=np.int32), (b, t)).copy()
    kp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    dout = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    return q, k, v, qp, kp, dout


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_grads(q, k, v, qp, kp, dout, causal, win, dtype=jnp.float32):
    """The reference's (out, dq, dk, dv): jax.vjp of its Pallas kernel."""
    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, jnp.asarray(qp), jnp.asarray(kp), win,
                         causal=causal, block_q=16, block_k=16,
                         interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return (np.asarray(out, np.float32),) + tuple(
        np.asarray(g, np.float32) for g in vjp(jnp.asarray(dout, dtype)))


def _function_grads(q, k, v, qp, kp, dout, causal, win):
    """(dq, dk, dv) of the port's FlashAttention on CPU tensors."""
    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention.flash_attention(qt, kt, vt, qp, kp, win,
                                          causal=causal)
    assert out.grad_fn is not None
    out.backward(dout)
    return qt.grad, kt.grad, vt.grad


def _wrong_bwd(kind, q, k, v, qp, kp, out, lse, dout, win, causal):
    """The plain backward with one fault: "dq_tile" drops the keys at
    positions 0-63 from dq; "dkv_tile" drops query rows 0-63 from dk and
    dv; "dkv_head" sums only the first query head of each group into dk
    and dv.  → (dq, dk, dv)."""
    dq, dk, dv = ref.flash_bwd_ref(q, k, v, qp, kp, out, lse, dout, win,
                                   causal)
    if kind == "dq_tile":
        kp2 = torch.where(kp < 64, torch.full_like(kp, -1), kp)
        dq = ref.flash_bwd_dq_ref(q, k, v, qp, kp2, dout, lse,
                                  ref.flash_delta(out, dout), win, causal)
        return dq, dk, dv
    d0 = dout.clone()
    if kind == "dkv_tile":
        d0[:, :64] = 0
    else:
        g = q.shape[2] // k.shape[2]
        d0[:, :, torch.arange(q.shape[2]) % g != 0] = 0
    dk, dv = ref.flash_bwd_dkv_ref(q, k, v, qp, kp, d0, lse,
                                   ref.flash_delta(out, d0), win, causal)
    return dq, dk, dv


def _row_excess(got, want):
    """The largest ‖got − want‖ over the bf16 limit of that row."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    norm = np.linalg.norm(want, axis=-1)
    limit = BF16_ROW * norm + BF16_FLOOR * norm.max()
    return float((np.linalg.norm(got - want, axis=-1) / limit).max())


@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_ref_matches_reference_kernel(case):
    b, t, s, h, d, causal, win = case
    q, k, v, qp, kp, dout = _mk(case)
    _, *want = _jax_grads(q, k, v, qp, kp, dout, causal, win)
    qt, kt, vt, qpt, kpt, dt = _torch(q, k, v, qp, kp, dout)
    out, lse = ref.flash_fwd_ref(qt, kt, vt, qpt, kpt, win, causal)
    got = ref.flash_bwd_ref(qt, kt, vt, qpt, kpt, out, lse, dt, win, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", CASES[:2] + CASES[-1:])
def test_function_on_cpu_is_the_plain_backward(case):
    """The Function's CPU route: autograd through ``flash_attention``
    gives exactly the plain backward and counts no launch."""
    b, t, s, h, d, causal, win = case
    qt, kt, vt, qpt, kpt, dt = _torch(*_mk(case, seed=1))
    before = dict(_build.LAUNCHES)
    got = _function_grads(qt, kt, vt, qpt, kpt, dt, causal, win)
    out, lse = ref.flash_fwd_ref(qt, kt, vt, qpt, kpt, win, causal)
    want = ref.flash_bwd_ref(qt, kt, vt, qpt, kpt, out, lse, dt, win, causal)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_ref_matches_autograd_of_plain_attention(case):
    """In float32 the plain backward equals autograd through the port's
    plain chunked ``layers.attention`` (every case has a visible key in
    each row, where the two definitions agree)."""
    b, t, s, h, d, causal, win = case
    qt, kt, vt, qpt, kpt, dt = _torch(*_mk(case, seed=2))
    out, lse = ref.flash_fwd_ref(qt, kt, vt, qpt, kpt, win, causal)
    got = ref.flash_bwd_ref(qt, kt, vt, qpt, kpt, out, lse, dt, win, causal)
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    plain = torch_layers.attention(*leaves, qpt, kpt, causal=causal,
                                   window=win)
    plain.backward(dt)
    for name, a, x in zip(("dq", "dk", "dv"), got, leaves):
        np.testing.assert_allclose(a.numpy(), x.grad.numpy(), atol=ATOL,
                                   err_msg=name)


def test_bf16_matches_reference_kernel():
    """bf16 operands, the reference's own out (and the port's lse, within
    1e-5 of the reference's) fed to the plain backward, and beside it the
    Function's route with the port's own forward: per-row limit."""
    case = CASES[-1]
    b, t, s, h, d, causal, win = case
    q, k, v, qp, kp, dout = _mk(case, seed=3)
    out, *want = _jax_grads(q, k, v, qp, kp, dout, causal, win,
                            dtype=jnp.bfloat16)
    qb, kb, vb, db = (t_.bfloat16() for t_ in _torch(q, k, v, dout))
    qpt, kpt = _torch(qp, kp)
    ob = torch.from_numpy(out).bfloat16()
    _, lse = ref.flash_fwd_ref(qb, kb, vb, qpt, kpt, win, causal)
    got = ref.flash_bwd_ref(qb, kb, vb, qpt, kpt, ob, lse, db, win, causal)
    fn = _function_grads(qb, kb, vb, qpt, kpt, db, causal, win)
    for name, a, f, w in zip(("dq", "dk", "dv"), got, fn, want):
        assert a.dtype == torch.bfloat16 and f.dtype == torch.bfloat16
        assert _row_excess(a.float(), w) <= 1.0, name
        assert _row_excess(f.float(), w) <= 1.0, name


@pytest.mark.parametrize("case", GQA_CASES)
def test_gqa_matches_reference_trainpath(case, monkeypatch):
    """k and v at KV heads: the port reads KV head h // g in place and its
    dk, dv sum the group; the reference expands and lets autodiff sum."""
    b, t, s, h, kv, d, causal, win = case
    q, k, v, qp, kp, dout = _mk((b, t, s, h, d), seed=4, kv=kv)
    monkeypatch.setattr(jax_layers, "ATTN_IMPL", "flash")
    monkeypatch.setattr(torch_layers, "ATTN_IMPL", "flash")
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_layers.attention_trainpath(
        q_, k_, v_, jnp.asarray(qp), jnp.asarray(kp), win),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    qt, kt, vt, qpt, kpt, dt = _torch(q, k, v, qp, kp, dout)
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    torch_layers.attention_trainpath(*leaves, qpt, kpt, win).backward(dt)
    for name, x, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   atol=ATOL, err_msg=name)


def test_a_row_that_sees_no_key_gets_no_gradient():
    """Keys at k_pos < 0 are hidden; three rows see none.  Their dq is 0
    (the forward's out there is the mean of v, but the backward masks p
    to 0, as the reference's kernels do) and they add nothing to dk and
    dv: the same dk, dv bit for bit with their dout zeroed."""
    b, t, s, h, d = 1, 6, 40, 2, 16
    q, k, v, _, _, dout = _mk((b, t, s, h, d), seed=5)
    kp = np.arange(s, dtype=np.int32)[None].copy()
    kp[0, :20] = -1
    qp = np.array([[0, 5, 19, 20, 30, 39]], np.int32)
    _, *want = _jax_grads(q, k, v, qp, kp, dout, True, 0)
    qt, kt, vt, qpt, kpt, dt = _torch(q, k, v, qp, kp, dout)
    out, lse = ref.flash_fwd_ref(qt, kt, vt, qpt, kpt, 0, True)
    dq, dk, dv = ref.flash_bwd_ref(qt, kt, vt, qpt, kpt, out, lse, dt, 0,
                                   True)
    assert bool((dq[0, :3] == 0).all()) and bool(dq[0, 3:].abs().sum() > 0)
    d0 = dt.clone()
    d0[0, :3] = 0
    _, dk0, dv0 = ref.flash_bwd_ref(qt, kt, vt, qpt, kpt, out, lse, d0, 0,
                                    True)
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kind", ["dq_tile", "dkv_tile", "dkv_head"])
def test_limits_fail_the_wrong_backwards(kind):
    """Each wrong backward fails the float32 atol against the reference
    and the bf16 per-row limit against the right plain backward, on the
    outputs it touches (a GQA case: two query heads a group)."""
    case = GQA_CASES[0]
    b, t, s, h, kv, d, causal, win = case
    q, k, v, qp, kp, dout = _mk((b, t, s, h, d), seed=6, kv=kv)
    qt, kt, vt, qpt, kpt, dt = _torch(q, k, v, qp, kp, dout)
    touched = ("dq",) if kind == "dq_tile" else ("dk", "dv")
    out, lse = ref.flash_fwd_ref(qt, kt, vt, qpt, kpt, win, causal)
    right = ref.flash_bwd_ref(qt, kt, vt, qpt, kpt, out, lse, dt, win,
                              causal)
    wrong = _wrong_bwd(kind, qt, kt, vt, qpt, kpt, out, lse, dt, win, causal)
    for name, r, w in zip(("dq", "dk", "dv"), right, wrong):
        err = float((r - w).abs().max())
        assert (err > ATOL) == (name in touched), (name, err)
    bf = [x.bfloat16() for x in (qt, kt, vt, dt)]
    out, lse = ref.flash_fwd_ref(bf[0], bf[1], bf[2], qpt, kpt, win, causal)
    right = ref.flash_bwd_ref(bf[0], bf[1], bf[2], qpt, kpt, out, lse, bf[3],
                              win, causal)
    wrong = _wrong_bwd(kind, bf[0], bf[1], bf[2], qpt, kpt, out, lse, bf[3],
                       win, causal)
    for name, r, w in zip(("dq", "dk", "dv"), right, wrong):
        excess = _row_excess(w.float(), r.float())
        assert (excess > 1.0) == (name in touched), (name, excess)


def test_flash_bwd_checks_its_operands():
    q, k, v, qp, kp, dout = _torch(*_mk(CASES[0]))
    out, lse = ref.flash_fwd_ref(q, k, v, qp, kp, 0, True)
    delta = ref.flash_delta(out, dout)
    assert delta.shape == lse.shape and delta.dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        flash_attention.flash_bwd_dq(q, k, v, qp, kp, dout.bfloat16(), lse,
                                     delta, 0)
    with pytest.raises(ValueError, match="shape"):
        flash_attention.flash_bwd_dkv(q, k, v, qp, kp, dout, lse[:, :1],
                                      delta, 0)
    with pytest.raises(TypeError, match="int32"):
        flash_attention.flash_bwd(q, k, v, qp.long(), kp, out, lse, dout, 0)
