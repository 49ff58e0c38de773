"""The port's flash-attention forward (plain version ``ref.flash_fwd_ref``
and the wrapper's CPU route) against the reference's Pallas kernel in
interpret mode (``block_q = block_k = 16``), on the reference test's
cases plus head_dim 80 (the full config's) and a bf16 case.

Tolerances: float32 ``atol = 2e-6``, the reference test's own (one-shot
against tiled online softmax: both sum in float32, in other orders).
bf16 ``atol = 3e-2``, the reference's bf16 limit; p is rounded to bf16
against the global row max here and against the running tile max there,
so single entries of out differ by up to a few bf16 ulps — measured at
most 3.9e-3 absolute and 3.9e-3 of the row's norm on the case below
(jax 0.9.0 on the CPU).
lse against a float32 ``logsumexp`` recomputed in JAX: ``atol = 1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import layers as jax_layers
from repro_torch.kernels import _build, flash_attention, ref

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


def _mk(case, seed=0):
    b, t, s, h, d, causal, win = case
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    qp = np.broadcast_to(np.arange(s - t, s, dtype=np.int32), (b, t)).copy()
    kp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return q, k, v, qp, kp, causal, win


def _jax_lse(q, k, qp, kp, causal, win):
    """(B, H, T) float32 logsumexp of the masked, scaled logits."""
    d = q.shape[-1]
    logits = jnp.einsum("bthd,bshd->bhts", q, k) * float(1.0 / d ** 0.5)
    dpos = qp[:, :, None] - kp[:, None, :]
    mask = (kp[:, None, :] >= 0) & ((win <= 0) | (dpos < win))
    if causal:
        mask = mask & (dpos >= 0)
    logits = jnp.where(mask[:, None], logits, -1e30)
    return jax.nn.logsumexp(logits, axis=-1)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_flash_fwd_ref_matches_reference_kernel(case):
    q, k, v, qp, kp, causal, win = _mk(case)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(qp), jnp.asarray(kp), win, causal=causal,
                     block_q=16, block_k=16, interpret=True)
    out, lse = ref.flash_fwd_ref(*_torch(q, k, v, qp, kp), win, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-6)
    want_lse = _jax_lse(q, k, qp, kp, causal, win)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)


@pytest.mark.parametrize("case", CASES[:2] + CASES[-1:])
def test_wrapper_on_cpu_takes_the_plain_version(case):
    """CPU tensors take the plain version (bit-equal) and count no launch;
    GQA read in place equals the expanded heads."""
    q, k, v, qp, kp, causal, win = _mk(case)
    before = dict(_build.LAUNCHES)
    got = flash_attention.flash_attention(*_torch(q, k, v, qp, kp), win,
                                          causal=causal)
    want, _ = ref.flash_fwd_ref(*_torch(q, k, v, qp, kp), win, causal)
    assert torch.equal(got, want)
    assert _build.LAUNCHES == before
    h = q.shape[2]
    if h % 2 == 0:       # two query heads per KV head
        kg, vg = k[:, :, ::2], v[:, :, ::2]
        got_g, _ = flash_attention.flash_fwd(*_torch(q, kg, vg, qp, kp), win,
                                             causal)
        want_g, _ = ref.flash_fwd_ref(*_torch(q, np.repeat(kg, 2, 2),
                                              np.repeat(vg, 2, 2), qp, kp),
                                      win, causal)
        assert torch.equal(got_g, want_g)


def test_bf16_matches_reference_kernel():
    q, k, v, qp, kp, causal, win = _mk(CASES[0])
    bf = jnp.bfloat16
    want = jax_flash(jnp.asarray(q, bf), jnp.asarray(k, bf),
                     jnp.asarray(v, bf), jnp.asarray(qp), jnp.asarray(kp),
                     win, causal=causal, block_q=16, block_k=16,
                     interpret=True)
    qt, kt, vt, qpt, kpt = _torch(q, k, v, qp, kp)
    out, _ = ref.flash_fwd_ref(qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
                               qpt, kpt, win, causal)
    assert out.dtype == torch.bfloat16
    got, want = out.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=3e-2)
    row_rel = np.linalg.norm(got - want, axis=-1) \
        / np.linalg.norm(want, axis=-1)
    assert row_rel.max() <= 2 ** -6          # four bf16 roundings (2⁻⁸)


def test_a_row_that_sees_no_key_is_the_mean_of_v():
    """Keys at k_pos < 0 are hidden; a row that sees none gets p = 1 on
    every key (−1e30 − (−1e30) = 0), as the reference's plain attention
    computes it, and no NaN."""
    b, t, s, h, d = 1, 6, 40, 2, 16
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    kp = np.arange(s, dtype=np.int32)[None].copy()
    kp[0, :20] = -1
    qp = np.array([[0, 5, 19, 20, 30, 39]], np.int32)   # 3 rows see nothing
    want = jax_layers.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(qp),
                                jnp.asarray(kp), causal=True, window=0,
                                k_valid=jnp.asarray(kp >= 0))
    out, lse = ref.flash_fwd_ref(*_torch(q, k, v, qp, kp), 0, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(out[0, :3].numpy(),
                               np.broadcast_to(v.mean(axis=1), (3, h, d)),
                               atol=2e-6)
    assert bool(torch.isfinite(lse).all())


def test_wrapper_checks_its_operands():
    q, k, v, qp, kp, causal, win = _mk(CASES[0])
    qt, kt, vt, qpt, kpt = _torch(q, k, v, qp, kp)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_fwd(qt.double(), kt, vt, qpt, kpt, win)
    with pytest.raises(TypeError, match="float32"):
        flash_attention.flash_fwd(qt, kt.bfloat16(), vt, qpt, kpt, win)
    with pytest.raises(TypeError, match="int32"):
        flash_attention.flash_fwd(qt, kt, vt, qpt.long(), kpt, win)
    with pytest.raises(ValueError, match="group"):
        flash_attention.flash_fwd(qt[:, :, :1].repeat(1, 1, 3, 1)
                                  .contiguous(), kt, vt, qpt, kpt, win)
