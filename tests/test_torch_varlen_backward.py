"""The port's varlen flash-attention backward (K8; K8a dq and K8b dk/dv
in f32): the plain backward and ``VarlenFlashAttentionFunction`` held
against ``jax.grad`` of paddle_tpu's Pallas varlen kernel.

On the CPU the port's wrappers run their plain PyTorch versions and the
Pallas kernel runs in interpret mode, so these tests check the plain
backward's arithmetic (the oracle the CUDA kernels are held to on the
card, tests/test_torch_cuda.py) and that the Function routes through it.
Inputs are seeded numpy arrays fed to both packages, f32 unless said.
Tolerances: gradients within ``2e-4`` of each gradient's largest |g| (the
reference's own test tolerance, tests/test_pallas_kernels.py: the two
sides sum in other orders); outputs ``2e-5``; the one bf16 case within
the reference's bf16 roundings (its docstring counts them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.varlen_flash_attention import (
    varlen_flash_attention as jax_varlen,
)
from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import functional as F

GTOL = 2e-4
OTOL = dict(rtol=2e-5, atol=2e-5)

# (lens_q, lens_k or None for the same, H, HK, D, causal, window, padding
# rows past cu_q[-1])
CASES = {
    # the shapes of tests/test_pallas_kernels.py's varlen grads test
    "ragged_gqa": ([13, 37, 1, 77], None, 4, 2, 64, True, None, 0),
    "ragged_gqa_noncausal": ([13, 37, 1, 77], None, 4, 2, 64, False, None,
                             0),
    # unequal q / kv lengths per segment: bottom-right causal
    "cross_lengths": ([9, 25, 40], [17, 25, 61], 4, 4, 64, True, None, 0),
    "cross_lengths_noncausal": ([9, 25, 40], [17, 25, 61], 4, 4, 64, False,
                                None, 0),
    # a per-segment window, segments longer and shorter than it
    "window": ([50, 7, 90, 30], None, 4, 2, 64, True, 16, 0),
    "head_dim_128": ([30, 70, 5], None, 4, 1, 128, True, None, 0),
    "empty_segments": ([20, 0, 33, 0, 11], None, 4, 2, 64, True, None, 0),
    # segment 1 has queries and no keys, segment 2 more queries than keys
    # (its first rows see no key), and 5 padding rows past cu_q[-1]
    "rows_without_keys": ([6, 10, 12], [9, 0, 4], 4, 2, 64, True, None, 5),
}


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _case(name, seed=0):
    lens_q, lens_k, h, hk, d, causal, window, pad = CASES[name]
    lens_k = lens_q if lens_k is None else lens_k
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    tq, tk = int(cu_q[-1]) + pad, int(cu_k[-1])
    rng = np.random.RandomState(seed)
    arrays = dict(
        q=rng.randn(tq, h, d).astype(np.float32),
        k=rng.randn(tk, hk, d).astype(np.float32),
        v=rng.randn(tk, hk, d).astype(np.float32),
        t=rng.randn(tq, h, d).astype(np.float32))
    return arrays, cu_q, cu_k, causal, window


def _jax_grads(a, cu_q, cu_k, causal, window):
    def loss(q, k, v):
        out = jax_varlen(q, k, v, jnp.asarray(cu_q), jnp.asarray(cu_k),
                         causal=causal, window_size=window)
        return jnp.sum(out * a["t"]), out

    (_, out), grads = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
        jnp.asarray(a["q"]), jnp.asarray(a["k"]), jnp.asarray(a["v"]))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def _assert_grads(got, want, label):
    for name, g, w in zip("qkv", got, want):
        g = g.detach().numpy()
        assert np.isfinite(g).all(), (label, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=GTOL * scale,
                                   err_msg=f"{label}: d{name}")


@pytest.mark.parametrize("name", list(CASES))
def test_function_and_plain_backward_match_pallas(name):
    a, cu_q, cu_k, causal, window = _case(name)
    want_out, want = _jax_grads(a, cu_q, cu_k, causal, window)
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)

    q, k, v = _t(a["q"], True), _t(a["k"], True), _t(a["v"], True)
    out = ops.VarlenFlashAttentionFunction.apply(q, k, v, cq, ck, causal,
                                                 None, window)
    assert type(out.grad_fn).__name__ == \
        "VarlenFlashAttentionFunctionBackward"
    np.testing.assert_allclose(out.detach().numpy(), want_out, **OTOL)
    (out * _t(a["t"])).sum().backward()
    _assert_grads((q.grad, k.grad, v.grad), want, "Function")

    o, lse = ops.varlen_flash_attention_plain(
        _t(a["q"]), _t(a["k"]), _t(a["v"]), cq, ck, causal,
        window_size=window)
    assert lse.shape == (a["q"].shape[1], a["q"].shape[0])
    do = _t(a["t"])
    plain = ops.varlen_flash_attention_bwd_plain(
        _t(a["q"]), _t(a["k"]), _t(a["v"]), o, lse, do, cq, ck, causal,
        window_size=window)
    _assert_grads(plain, want, "plain")
    # the dq / dk, dv wrappers take their plain versions on CPU tensors
    delta = ops.varlen_flash_attention_bwd_delta(o, do)
    assert delta.shape == lse.shape and delta.dtype == torch.float32
    args = (_t(a["q"]), _t(a["k"]), _t(a["v"]), do, lse, delta, cq, ck,
            causal)
    dq = ops.varlen_flash_attention_bwd_dq(*args, window_size=window)
    dk, dv = ops.varlen_flash_attention_bwd_dkv(*args, window_size=window)
    for x, y in zip((dq, dk, dv), plain):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_rows_without_keys_get_zero_dq():
    a, cu_q, cu_k, causal, window = _case("rows_without_keys")
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    q, k, v = _t(a["q"]), _t(a["k"]), _t(a["v"])
    o, lse = ops.varlen_flash_attention_plain(q, k, v, cq, ck, causal)
    dq, dk, dv = ops.varlen_flash_attention_bwd_plain(
        q, k, v, o, lse, _t(a["t"]), cq, ck, causal)
    # segment 1 (queries 6..15) has no keys; segment 2's 12 queries over 4
    # keys: its first 8 see none; rows 28.. are padding
    dead = list(range(6, 16)) + list(range(16, 24)) + list(range(28, 33))
    assert float(lse[:, dead].max()) < -1e29
    assert float(dq[dead].abs().max()) == 0.0
    assert float(o[dead].abs().max()) == 0.0
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    # the keys of segment 0 the causal mask leaves to nobody: segment 0
    # has 6 queries over 9 keys, bottom-right, so every key is seen
    assert float(dk[:9].abs().max()) > 0


def test_flash_attn_unpadded_carries_the_function_and_checks_args():
    a, cu_q, cu_k, causal, window = _case("window")
    cq = torch.from_numpy(cu_q)
    q, k, v = _t(a["q"], True), _t(a["k"], True), _t(a["v"], True)
    out, soft = F.flash_attn_unpadded(q, k, v, cq, cq, 90, 90, scale=0.125,
                                      causal=True, window_size=16)
    assert soft is None
    assert type(out.grad_fn).__name__ == \
        "VarlenFlashAttentionFunctionBackward"
    want = ops.varlen_flash_attention_plain(q, k, v, cq, cq, True, 0.125,
                                            16)[0]
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="causal"):
        F.flash_attn_unpadded(q, k, v, cq, cq, 90, 90, 0.125,
                              window_size=16)
    with pytest.raises(ValueError, match=">= 1"):
        F.flash_attn_unpadded(q, k, v, cq, cq, 90, 90, 0.125, causal=True,
                              window_size=0)
    with pytest.raises(NotImplementedError, match="dropout"):
        F.flash_attn_unpadded(q, k, v, cq, cq, 90, 90, 0.125, dropout=0.1)
    # dropout outside training is no dropout
    out, _ = F.flash_attn_unpadded(q, k, v, cq, cq, 90, 90, 0.125,
                                   dropout=0.1, causal=True, training=False)
    assert out.shape == q.shape


def test_function_takes_a_strided_upstream_gradient():
    """The upstream gradient arrives as a view of what the caller
    reshaped (here a transposed one); the Function makes it contiguous."""
    a, cu_q, cu_k, causal, window = _case("ragged_gqa")
    cq = torch.from_numpy(cu_q)
    q, k, v = _t(a["q"], True), _t(a["k"], True), _t(a["v"], True)
    out = ops.VarlenFlashAttentionFunction.apply(q, k, v, cq, cq, True)
    t = _t(a["t"]).transpose(0, 1).contiguous().transpose(0, 1)
    assert not t.is_contiguous()
    out.backward(t)
    _, want = _jax_grads(a, cu_q, cu_k, True, None)
    _assert_grads((q.grad, k.grad, v.grad), want, "strided")


def test_bf16_gqa_group_sum_stays_within_the_references_roundings():
    """bf16, GQA group 4: the reference writes each query head's dk / dv
    in bf16 and sums the group (``_varlen_bwd``'s ``jnp.repeat`` and
    ``.sum``), the port sums the group in f32 and rounds once. Each of the
    reference's G + 1 roundings moves a value by at most 2^-9 of the
    largest |g|, and P and dS round once on each side, so dk and dv agree
    within (G + 2) * 2^-9 of the largest |g|, dq (no group sum) within
    2 * 2^-9."""
    rng = np.random.RandomState(0)
    cu = _cu([13, 37, 1, 77])
    t, h, hk, d = int(cu[-1]), 8, 2, 64
    group = h // hk
    x = [jnp.asarray(rng.randn(t, n, d), jnp.bfloat16)
         for n in (h, hk, hk, h)]
    want = jax.grad(lambda q, k, v: jnp.sum(
        (jax_varlen(q, k, v, jnp.asarray(cu), jnp.asarray(cu), causal=True)
         * x[3]).astype(jnp.float32)), (0, 1, 2))(*x[:3])
    q, k, v, do = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                   for a in x)
    q, k, v = (a.requires_grad_() for a in (q, k, v))
    cq = torch.from_numpy(cu)
    out = ops.VarlenFlashAttentionFunction.apply(q, k, v, cq, cq, True)
    (out.float() * do.float()).sum().backward()
    for name, g, w, steps in (("q", q.grad, want[0], 2),
                              ("k", k.grad, want[1], group + 2),
                              ("v", v.grad, want[2], group + 2)):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        err = np.abs(g.float().numpy() - w).max()
        assert err <= steps * 2.0 ** -9 * np.abs(w).max(), (name, err)
