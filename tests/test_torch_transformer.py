"""The port's transformer layers (``nn.MultiHeadAttention``, the encoder
and decoder layers and stacks, ``nn.Transformer``) held against
paddle_tpu's on the CPU. Each reference layer is built from a seed and
its weights carried with ``nlp.convert`` (Linear weights transposed);
inputs come from ``np.random.RandomState``.

Widths: d_model 32 with 2 heads (D = 16: the plain attention in both
packages) and d_model 128 with 2 heads or 64 with 1 (D = 64: with no
mask the port
takes ``FlashAttentionFunction``, the plain versions of K4 and K7 on the
CPU, while the reference's CPU run takes XLA's attention).

Tolerances, each with its reason:
- f32 outputs and cached steps: ``2e-5`` absolute and relative (the same
  f32 products, LayerNorms and softmax summed in other orders; the flash
  plain version normalises after its product);
- gradients of a loss over ``Transformer``'s output: ``1e-4`` of each
  gradient's largest |value| (the backward's sums, through up to four
  layers, in other orders). A key projection's bias has a zero gradient
  in exact arithmetic (the softmax cancels it), so both packages compute
  rounding noise there: it is held to ``1e-4`` of the largest gradient of
  all.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
from paddle_tpu_torch import nn
from paddle_tpu_torch.nlp import load_paddle_tpu_arrays

RTOL = ATOL = 2e-5


def _x(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _carry(ref, port):
    load_paddle_tpu_arrays(port, {k: np.asarray(v._value, np.float32)
                                  for k, v in ref.state_dict().items()})
    return port


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return (t.numpy() if isinstance(t, paddle.Tensor)
            else t.detach().numpy())


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("embed,mask", [(32, None), (32, "bool"),
                                        (32, "additive"), (128, None),
                                        (128, "additive")])
def test_multi_head_attention_matches_reference(embed, mask):
    paddle.seed(0)
    ref = rnn.MultiHeadAttention(embed, 2)
    mha = _carry(ref, nn.MultiHeadAttention(embed, 2))
    q, kv = _x(2, 6, embed), _x(2, 9, embed, seed=1)
    m = None
    if mask == "bool":
        m = np.random.RandomState(2).rand(2, 1, 6, 9) > 0.3
        m[..., 0] = True
    elif mask == "additive":
        m = np.where(np.random.RandomState(2).rand(2, 2, 6, 9) > 0.3, 0.0,
                     -1e9).astype(np.float32)
    want = ref(paddle.to_tensor(q), paddle.to_tensor(kv),
               attn_mask=None if m is None else paddle.to_tensor(m))
    got = mha(_t(q), _t(kv), attn_mask=None if m is None else _t(m))
    assert tuple(got.shape) == (2, 6, embed)
    _close(got, want)


@pytest.mark.parametrize("embed", [32, 128])
def test_incremental_and_static_caches_match_reference(embed):
    paddle.seed(1)
    ref = rnn.MultiHeadAttention(embed, 2)
    mha = _carry(ref, nn.MultiHeadAttention(embed, 2))
    xs, mem = _x(2, 4, embed, seed=3), _x(2, 5, embed, seed=4)
    rc = ref.gen_cache(paddle.to_tensor(xs))
    c = mha.gen_cache(_t(xs))
    assert isinstance(c, nn.MultiHeadAttention.Cache)
    assert tuple(c.k.shape) == (2, 0, 2, embed // 2)
    for i in range(4):
        step = xs[:, i:i + 1]
        rout, rc = ref(paddle.to_tensor(step), cache=rc)
        out, c = mha(_t(step), cache=c)
        _close(out, rout)
    assert tuple(c.k.shape) == (2, 4, 2, embed // 2)
    _close(c.v, rc.v)
    rs = ref.gen_cache(paddle.to_tensor(mem), paddle.to_tensor(mem),
                       type=rnn.MultiHeadAttention.StaticCache)
    s = mha.gen_cache(_t(mem), _t(mem), type=nn.MultiHeadAttention.StaticCache)
    _close(s.k, rs.k)
    _close(mha(_t(xs), cache=s), ref(paddle.to_tensor(xs), cache=rs))


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_encoder_and_decoder_stacks_match_reference(kind, normalize_before):
    paddle.seed(2)
    src, mem = _x(2, 7, 32, seed=5), _x(2, 6, 32, seed=6)
    if kind == "encoder":
        ref = rnn.TransformerEncoder(rnn.TransformerEncoderLayer(
            32, 2, 64, dropout=0.0, normalize_before=normalize_before), 2,
            rnn.LayerNorm(32) if normalize_before else None)
        port = nn.TransformerEncoder(nn.TransformerEncoderLayer(
            32, 2, 64, dropout=0.0, normalize_before=normalize_before), 2,
            nn.LayerNorm(32) if normalize_before else None)
        mask = np.where(np.arange(7) < 5, 0.0, -1e9).astype(
            np.float32)[None, None, None]
        want = ref(paddle.to_tensor(src), paddle.to_tensor(mask))
        got = _carry(ref, port)(_t(src), _t(mask))
    else:
        ref = rnn.TransformerDecoder(rnn.TransformerDecoderLayer(
            32, 2, 64, dropout=0.0, normalize_before=normalize_before), 2)
        port = nn.TransformerDecoder(nn.TransformerDecoderLayer(
            32, 2, 64, dropout=0.0, normalize_before=normalize_before), 2)
        causal = nn.Transformer.generate_square_subsequent_mask(7)
        want = ref(paddle.to_tensor(src), paddle.to_tensor(mem),
                   rnn.Transformer.generate_square_subsequent_mask(7))
        got = _carry(ref, port)(_t(src), _t(mem), causal)
    _close(got, want)
    assert [n for n, _ in port.named_parameters()][0] == \
        "layers.0.self_attn.q_proj.weight"


def test_decoder_cached_steps_match_reference():
    paddle.seed(3)
    ref = rnn.TransformerDecoder(rnn.TransformerDecoderLayer(
        128, 2, 256, dropout=0.0), 2)
    port = _carry(ref, nn.TransformerDecoder(nn.TransformerDecoderLayer(
        128, 2, 256, dropout=0.0), 2))
    tgt, mem = _x(2, 5, 128, seed=7), _x(2, 8, 128, seed=8)
    rc = ref.gen_cache(paddle.to_tensor(mem))
    c = port.gen_cache(_t(mem))
    for i in range(5):
        step = tgt[:, i:i + 1]
        rout, rc = ref(paddle.to_tensor(step), paddle.to_tensor(mem),
                       cache=rc)
        out, c = port(_t(step), _t(mem), cache=c)
        _close(out, rout)
    assert len(port.gen_cache(_t(mem), do_zip=True)) == 2


def test_transformer_forward_and_gradients_match_reference():
    paddle.seed(4)
    ref = rnn.Transformer(64, 1, 1, 1, 64, dropout=0.0)
    port = _carry(ref, nn.Transformer(64, 1, 1, 1, 64, dropout=0.0))
    src, tgt = _x(2, 6, 64, seed=9), _x(2, 5, 64, seed=10)
    w = _x(2, 5, 64, seed=11)
    mask = rnn.Transformer.generate_square_subsequent_mask(5)
    causal = nn.Transformer.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(causal.numpy(), mask.numpy())
    rout = ref(paddle.to_tensor(src), paddle.to_tensor(tgt), tgt_mask=mask)
    (rout * paddle.to_tensor(w)).sum().backward()
    out = port(_t(src), _t(tgt), tgt_mask=causal)
    (out * _t(w)).sum().backward()
    _close(out, rout)
    ref_grads = {k: np.asarray(p.grad._value, np.float32)
                 for k, p in ref.named_parameters()}
    from paddle_tpu_torch.nlp import paddle_tpu_arrays_to_port

    want = paddle_tpu_arrays_to_port(port, ref_grads)
    top = max(float(np.abs(g).max()) for g in want.values())
    for name, p in port.named_parameters():
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        if name.endswith("k_proj.bias"):
            scale = top  # zero in exact arithmetic: rounding noise
        assert float(np.abs(p.grad.numpy() - want[name]).max()) \
            <= 1e-4 * scale, name
