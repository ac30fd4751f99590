"""The port's attention kernels K4 (flash_attention forward) and K5
(decode_attention) and the functionals above them, held against
paddle_tpu's Pallas kernels and functionals.

On the CPU the port's wrappers run their plain PyTorch versions and the
Pallas kernels run in interpret mode, so these tests check the plain
versions' arithmetic (the oracle the CUDA kernels are held to on the card,
tests/test_torch_cuda.py). Tolerances: f32 ``2e-5`` (the reference tests'
own; only the summation order differs); bf16 one bf16 rounding step (both
sides compute in f32 and round once; K4 also rounds P to bf16 on both
sides before P.V).
"""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as RIF
from paddle_tpu.nn import functional as RF
from paddle_tpu.ops.pallas.decode_attention import (
    decode_attention as jax_decode_attention,
)
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from paddle_tpu_torch import ops
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.nn import functional as F

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=8e-3, atol=1e-2)   # one bf16 rounding step (2^-7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(a):
    """float32 values exactly representable in bf16 (same bits both sides)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("sq,sk,h,hk,causal,window", [
    # tests/test_pallas_kernels.py::test_flash_attention_fwd_bwd's shapes
    (128, 128, 2, 2, False, None),
    (128, 128, 2, 2, True, None),
    (100, 100, 2, 2, True, None),     # ragged
    (64, 128, 2, 1, True, None),      # bottom-right causal + MQA
    (96, 200, 4, 2, False, None),     # ragged + GQA
    (256, 256, 4, 4, True, None),     # multi-block
    # ::test_flash_sliding_window_matches_masked_reference's window band
    (100, 100, 4, 4, True, 17),
])
def test_flash_attention_plain_matches_pallas(sq, sk, h, hk, causal, window):
    rng = np.random.RandomState(0)
    q = rng.randn(2, sq, h, 64).astype("f4")
    k = rng.randn(2, sk, hk, 64).astype("f4")
    v = rng.randn(2, sk, hk, 64).astype("f4")
    kw = dict(block_q=32, block_k=32) if window else {}
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window_size=window, **kw)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window_size=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_attention_bottom_right_matches_pallas():
    """::test_flash_attention_bottom_right_causal_matches_xla_fallback."""
    rng = np.random.RandomState(1)
    q = rng.randn(1, 8, 2, 64).astype("f4")
    k = rng.randn(1, 128, 2, 64).astype("f4")
    v = rng.randn(1, 128, 2, 64).astype("f4")
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_attention_plain_matches_pallas_bf16():
    rng = np.random.RandomState(2)
    q, k, v = (_bf16_np(rng.randn(2, 96, 4, 64).astype("f4"))
               for _ in range(3))
    want = jax_flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)), causal=True)
    got = ops.flash_attention(*(_t(x).bfloat16() for x in (q, k, v)),
                              causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_flash_attention_lse_and_empty_rows():
    """lse = log-sum-exp of the live scaled scores; rows with no live key
    (Sq > Sk, bottom-right causal) give zeros and lse ~ -1e30."""
    rng = np.random.RandomState(3)
    q = rng.randn(1, 12, 2, 16).astype("f4")
    k = rng.randn(1, 8, 2, 16).astype("f4")
    out, lse = ops.flash_attention(_t(q), _t(k), _t(k), causal=True,
                                   return_lse=True)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    live = np.arange(8)[None, :] <= np.arange(12)[:, None] - 4
    for i in range(12):
        if live[i].any():
            row = s[0, :, i][:, live[i]]
            want = np.log(np.exp(row - row.max(-1, keepdims=True)).sum(-1)) \
                + row.max(-1)
            np.testing.assert_allclose(lse[0, :, i].numpy(), want, **F32)
        else:
            assert (out[0, i] == 0).all() and (lse[0, :, i] < -1e29).all()


def test_flash_attention_rejects_bad_arguments():
    q = torch.zeros(1, 16, 3, 64)
    k = torch.zeros(1, 16, 2, 64)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, k)
    q = torch.zeros(1, 16, 2, 64)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, k, k, window_size=4)
    with pytest.raises(ValueError, match=">= 1"):
        ops.flash_attention(q, k, k, causal=True, window_size=0)


# ------------------------------------------------------------------ K5
@pytest.mark.parametrize("b,h,hk,smax", [(2, 4, 4, 256), (2, 8, 2, 300)])
def test_decode_attention_plain_matches_pallas(b, h, hk, smax):
    """::test_decode_attention's shapes and lengths."""
    rng = np.random.RandomState(4)
    q = rng.randn(b, h, 64).astype("f4")
    kc = rng.randn(b, smax, hk, 64).astype("f4")
    vc = rng.randn(b, smax, hk, 64).astype("f4")
    lens = rng.randint(1, smax, size=(b,)).astype(np.int32)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(lens))
    got = ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_attention_4d_query_matches_pallas():
    """::test_decode_attention_4d_query, plus a zero length (zeros)."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 1, 4, 64).astype("f4")
    kc = rng.randn(2, 128, 4, 64).astype("f4")
    vc = rng.randn(2, 128, 4, 64).astype("f4")
    lens = np.asarray([7, 128], np.int32)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(lens))
    got = ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    assert got.shape == (2, 1, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    zero = ops.decode_attention(_t(q), _t(kc), _t(vc),
                                torch.tensor([0, 3], dtype=torch.int32))
    assert (zero[0] == 0).all()


def test_decode_attention_plain_matches_pallas_bf16():
    rng = np.random.RandomState(6)
    q = _bf16_np(rng.randn(3, 8, 64).astype("f4"))
    kc = _bf16_np(rng.randn(3, 200, 2, 64).astype("f4"))
    vc = _bf16_np(rng.randn(3, 200, 2, 64).astype("f4"))
    lens = np.asarray([1, 120, 200], np.int32)
    want = jax_decode_attention(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, kc, vc)), jnp.asarray(lens))
    got = ops.decode_attention(*(_t(x).bfloat16() for x in (q, kc, vc)),
                               _t(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


# ------------------------------------------------------- functionals
def _qkv(rng, b=2, sq=20, sk=20, h=4, hk=2, d=16):
    return (rng.randn(b, sq, h, d).astype("f4"),
            rng.randn(b, sk, hk, d).astype("f4"),
            rng.randn(b, sk, hk, d).astype("f4"))


@pytest.mark.parametrize("case", ["causal", "dense", "bool_mask",
                                  "bias_mask", "bottom_right"])
def test_sdpa_matches_reference(case):
    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, sq=12 if case == "bottom_right" else 20)
    mask = None
    if case == "bool_mask":
        mask = rng.rand(2, 1, 20, 20) > 0.3
        mask[..., 0] = True                      # no empty row
    elif case == "bias_mask":
        mask = rng.randn(2, 4, 20, 20).astype("f4")
    causal = case in ("causal", "bottom_right")
    want = RF.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)),
        attn_mask=None if mask is None else paddle.to_tensor(mask),
        is_causal=causal).numpy()
    got = F.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=None if mask is None else _t(mask),
        is_causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    out, soft = F.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    if mask is None:
        np.testing.assert_allclose(out.numpy(), want, **F32)
    assert soft is None


def test_sliding_window_attention_matches_reference():
    rng = np.random.RandomState(8)
    q, k, v = _qkv(rng)
    want = RF.sliding_window_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)), 5).numpy()
    got = F.sliding_window_attention(_t(q), _t(k), _t(v), 5)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    with pytest.raises(ValueError, match=">= 1"):
        F.sliding_window_attention(_t(q), _t(k), _t(v), 0)


def test_sdpa_dropout_draws_from_the_generator():
    rng = np.random.RandomState(9)
    q, k, v = (_t(x) for x in _qkv(rng))

    def run(seed, training=True):
        return F.scaled_dot_product_attention(
            q, k, v, dropout_p=0.5, is_causal=True, training=training,
            generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    # eval mode ignores dropout: the flash path's result
    np.testing.assert_allclose(
        run(1, training=False).numpy(),
        F.scaled_dot_product_attention(q, k, v, is_causal=True).numpy(),
        **F32)


@pytest.mark.parametrize("variant", ["kernel", "src_mask", "out_scale",
                                     "4d"])
def test_masked_multihead_attention_matches_reference(variant):
    rng = np.random.RandomState(10)
    b, h, hk, smax, d = 3, 8, 2, 40, 16
    q = rng.randn(b, 1, h, d).astype("f4") if variant == "4d" \
        else rng.randn(b, h, d).astype("f4")
    ckv = rng.randn(2, b, smax, hk, d).astype("f4")
    lens = np.asarray([1, 17, 40], np.int32)
    kw = {}
    if variant == "src_mask":
        kw["src_mask"] = rng.randn(b, 1, 1, smax).astype("f4")
    if variant == "out_scale":
        kw["out_scale"] = 0.01
    want = RIF.masked_multihead_attention(
        paddle.to_tensor(q), cache_kv=paddle.to_tensor(ckv),
        sequence_lengths=paddle.to_tensor(lens),
        **{k: (paddle.to_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}).numpy()
    got = IF.masked_multihead_attention(
        _t(q), cache_kv=_t(ckv), sequence_lengths=_t(lens),
        **{k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if variant == "out_scale":
        # int8 codes: equal but where an f32 value sits on a rounding edge
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    else:
        np.testing.assert_allclose(got, want, **F32)
    with pytest.raises(ValueError, match="cache_kv"):
        IF.masked_multihead_attention(_t(q))
    assert math.isfinite(float(np.abs(got).max()))
