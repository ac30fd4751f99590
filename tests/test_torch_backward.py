"""The port's backward kernels K6 (rms_norm) and K7 (flash attention),
their autograd Functions, and the losses, held against paddle_tpu.

On the CPU the port's wrappers run their plain PyTorch versions and the
Pallas kernels run in interpret mode, so these tests check the plain
backwards' arithmetic (the oracle the CUDA kernels are held to on the
card, tests/test_torch_cuda.py) and that the Functions route through them.
Tolerances: f32 gradients ``2e-4`` absolute (``GTOL`` of
tests/test_pallas_kernels.py: the two sides sum in other orders); bf16 one
bf16 rounding step (``2^-7`` relative: both sides compute in f32 and round
once) plus ``1e-3`` absolute for values that cancel to near zero; losses
``1e-6`` relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import (
    fused_linear_cross_entropy as ref_fused_lce,
)
from paddle_tpu.nn import functional as RF
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from paddle_tpu.ops.pallas.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu_torch import ops
from paddle_tpu_torch.incubate.nn.functional import fused_linear_cross_entropy
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import _library as L

GTOL = dict(rtol=0, atol=2e-4)
BF16 = dict(rtol=2.0 ** -7, atol=1e-3)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------------- K6
@pytest.mark.parametrize("shape", [(4, 128, 512), (3, 100, 256), (7, 64)])
def test_rms_norm_backward_matches_pallas(shape):
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    t = rng.randn(*shape).astype(np.float32)
    want = jax.grad(lambda x, w: jnp.sum(jax_rms_norm(x, w) * t), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    (F.rms_norm(xt, wt) * _t(t)).sum().backward()
    _, rstd = ops.rms_norm_plain(_t(x), _t(w))
    plain = ops.rms_norm_bwd_plain(_t(x), _t(w), rstd, _t(t))
    for got in ((xt.grad, wt.grad), plain):
        for g, ref in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(ref), **GTOL)


def test_rms_norm_backward_matches_pallas_bf16():
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(8, 256), jnp.bfloat16)
    w = jnp.asarray(rng.randn(256), jnp.bfloat16)
    t = jnp.asarray(rng.randn(8, 256), jnp.bfloat16)
    want = jax.grad(
        lambda x, w: jnp.sum((jax_rms_norm(x, w) * t).astype(jnp.float32)),
        (0, 1))(x, w)
    xt = _t(np.asarray(x, np.float32)).bfloat16().requires_grad_()
    wt = _t(np.asarray(w, np.float32)).bfloat16().requires_grad_()
    tt = _t(np.asarray(t, np.float32)).bfloat16()
    (ops.RMSNormFunction.apply(xt, wt, 1e-6) * tt).float().sum().backward()
    for g, ref in zip((xt.grad, wt.grad), want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), np.asarray(ref, np.float32),
                                   **BF16)


def test_rms_norm_function_keeps_leading_dims_and_checks_shapes():
    x = torch.randn(2, 3, 8, requires_grad=True)
    w = torch.randn(8, requires_grad=True)
    y = ops.RMSNormFunction.apply(x, w, 1e-6)
    assert y.grad_fn is not None
    y.sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    with pytest.raises(ValueError, match="do not match"):
        ops.rms_norm_bwd(x.detach(), w.detach(), torch.ones(2, 3),
                         torch.ones(2, 8))


# ------------------------------------------------------------------- K7
CASES = [
    # the six cases of tests/test_pallas_kernels.py
    (128, 128, 2, 2, False, None, 64),
    (128, 128, 2, 2, True, None, 64),
    (100, 100, 2, 2, True, None, 64),   # ragged
    (64, 128, 2, 1, True, None, 64),    # bottom-right causal + MQA
    (96, 200, 4, 2, False, None, 64),   # ragged + GQA
    (256, 256, 4, 4, True, None, 64),   # multi-block
    # head dim 128, a sliding window, a GQA group of 4
    (96, 96, 2, 2, True, None, 128),
    (160, 160, 4, 2, True, 48, 64),
    (80, 80, 8, 2, True, None, 64),
]


@pytest.mark.parametrize("sq,sk,h,hk,causal,window,d", CASES)
def test_flash_attention_backward_matches_pallas(sq, sk, h, hk, causal,
                                                 window, d):
    rng = np.random.RandomState(0)
    q = rng.randn(2, sq, h, d).astype(np.float32)
    k = rng.randn(2, sk, hk, d).astype(np.float32)
    v = rng.randn(2, sk, hk, d).astype(np.float32)
    t = (rng.randn(2, sq, h, d) * 0.1).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_flash_attention(
            q, k, v, causal=causal, window_size=window) * t),
        (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = ops.FlashAttentionFunction.apply(qt, kt, vt, causal, None, window)
    assert out.grad_fn is not None
    (out * _t(t)).sum().backward()
    o, lse = ops.flash_attention_plain(_t(q), _t(k), _t(v), causal,
                                       window_size=window)
    plain = ops.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse,
                                          _t(t), causal, window_size=window)
    for got in ((qt.grad, kt.grad, vt.grad), plain):
        for g, ref in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(ref), **GTOL)


def test_flash_attention_backward_rows_without_keys_are_zero():
    # Sq > Sk, bottom-right causal: the first Sq - Sk queries see no key
    rng = np.random.RandomState(1)
    q = _t(rng.randn(1, 12, 2, 64).astype(np.float32))
    k = _t(rng.randn(1, 4, 2, 64).astype(np.float32))
    v = _t(rng.randn(1, 4, 2, 64).astype(np.float32))
    do = _t(rng.randn(1, 12, 2, 64).astype(np.float32))
    o, lse = ops.flash_attention_plain(q, k, v, True)
    dq, dk, dv = ops.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert float(dq[:, :8].abs().max()) == 0.0
    assert torch.isfinite(dv).all()


def test_sdpa_and_sliding_window_carry_the_function():
    q = torch.randn(1, 16, 4, 64, requires_grad=True)
    k = torch.randn(1, 16, 2, 64, requires_grad=True)
    v = torch.randn(1, 16, 2, 64, requires_grad=True)
    for out in (F.scaled_dot_product_attention(q, k, v, is_causal=True),
                F.sliding_window_attention(q, k, v, 4),
                F.flash_attention(q, k, v, causal=True)[0]):
        assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"


@pytest.mark.parametrize("grad_mode,requires,raises", [
    (True, True, True), (False, True, False), (True, False, False)])
def test_refuse_grad_logic(grad_mode, requires, raises):
    """The check the K2, K3 and K5 wrappers make on their kernel path: a
    kernel without a backward must not hand autograd a detached output."""
    x = torch.zeros(2, requires_grad=requires)
    with torch.set_grad_enabled(grad_mode):
        if raises:
            with pytest.raises(NotImplementedError, match="inference-only"):
                L.refuse_grad("decode_attention", "inference-only", x)
        else:
            L.refuse_grad("decode_attention", "inference-only", x)


# --------------------------------------------------------------- losses
def _ce_data(n=50, v=37, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n, v).astype(np.float32)
    y = r.randint(0, v, (n,)).astype(np.int64)
    y[[3, 7]] = -100
    return x, y


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_reference(reduction):
    x, y = _ce_data()
    xr = paddle.to_tensor(x, stop_gradient=False)
    ref = RF.cross_entropy(xr, paddle.to_tensor(y), reduction=reduction)
    ref.sum().backward()
    xt = _t(x, True)
    got = F.cross_entropy(xt, _t(y), reduction=reduction)
    got.sum().backward()
    np.testing.assert_allclose(_np(got), ref.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(xr.grad._value),
                               rtol=1e-5, atol=1e-7)


def _lce_data(n=50, h=16, v=37, seed=0):
    r = np.random.RandomState(seed)
    hid = r.randn(n, h).astype(np.float32)
    w = (r.randn(h, v) * 0.1).astype(np.float32)
    y = r.randint(0, v, (n,)).astype(np.int64)
    y[[3, 7] if n > 7 else []] = -100
    b = r.randn(v).astype(np.float32)
    return hid, w, y, b


@pytest.mark.parametrize("n,chunk,bias", [(50, 16, False), (23, 8, False),
                                          (32, 8, True)])
def test_fused_linear_cross_entropy_matches_reference(n, chunk, bias):
    hid, w, y, b = _lce_data(n)
    hr = paddle.to_tensor(hid, stop_gradient=False)
    wr = paddle.to_tensor(w, stop_gradient=False)
    br = paddle.to_tensor(b, stop_gradient=False) if bias else None
    ref = ref_fused_lce(hr, wr, paddle.to_tensor(y), bias=br,
                        chunk_rows=chunk)
    ref.backward()
    ht, wt = _t(hid, True), _t(w.T, True)   # torch Linear layout (V, H)
    bt = _t(b, True) if bias else None
    got = fused_linear_cross_entropy(ht, wt, _t(y), bias=bt,
                                     chunk_rows=chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(_np(ht.grad), np.asarray(hr.grad._value),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(wt.grad).T, np.asarray(wr.grad._value),
                               rtol=1e-5, atol=1e-7)
    if bias:
        np.testing.assert_allclose(_np(bt.grad), np.asarray(br.grad._value),
                                   rtol=1e-5, atol=1e-7)


def test_fused_linear_cross_entropy_bf16_forms_f32_logits():
    """bf16 hidden states and lm-head: each chunk's logits (and its dW
    product) are formed in f32 from the bf16 operands, as the reference's
    ``preferred_element_type`` does, not rounded to bf16 first. The f32
    loss agrees to ``1e-6``; dh and dW, both rounded once from f32 sums
    that differ only in order, agree exactly on all but a few elements
    (an f32 sum on a bf16 rounding boundary), and those within one bf16
    step. Logits rounded to bf16 before the softmax would move the loss
    by ~1e-3 and most of dh / dW by one or more bf16 steps."""
    hid, w, y, _ = _lce_data(n=96, h=64, v=300, seed=4)
    hid, w = hid * 4, w * 4    # logits of a few units: bf16 steps matter
    hb = jnp.asarray(hid, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    hr = paddle.to_tensor(hb, stop_gradient=False)
    wr = paddle.to_tensor(wb, stop_gradient=False)
    ref = ref_fused_lce(hr, wr, paddle.to_tensor(y), chunk_rows=32)
    ref.backward()
    ht = _t(np.asarray(hb, np.float32)).bfloat16().requires_grad_()
    wt = _t(np.asarray(wb, np.float32).T).bfloat16().requires_grad_()
    got = fused_linear_cross_entropy(ht, wt, _t(y), chunk_rows=32)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    for g, r in ((ht.grad, hr.grad), (wt.grad.t(), wr.grad)):
        assert g.dtype == torch.bfloat16
        a = _np(g)
        b = np.asarray(np.asarray(r._value), np.float32)
        assert (a != b).mean() <= 0.01
        np.testing.assert_allclose(a, b, rtol=2.0 ** -8, atol=1e-30)
