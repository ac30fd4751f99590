"""The port's FusedMultiTransformer and fused functionals held against
paddle_tpu's on the CPU. Weights are drawn by the reference from its seed
and carried with ``nlp.convert`` (the stacks copy as they are); inputs
come from ``np.random.RandomState``. Widths are the reference tests':
E = 64, 4 heads (D = 16), FFN 128, which run here on the kernels' plain
versions (the card's kernels take D = 64 and 128, ROADMAP A10).

Tolerances, each with its reason:
- port against reference in f32: outputs and caches ``1e-5`` absolute
  and relative (the same f32 products summed in other orders; decode
  attention is K5's plain version against the reference's
  ``_masked_decode_attn``, the same masked softmax wherever a row has a
  live key);
- weight-only int8 against the reference's int8 ``1e-5``; the int8
  stacks and scales themselves equal;
- the port's own decode against its full forward ``1e-4`` (the reference
  test's bound: decode attends one query in f32 where the prefill's
  flash path forms the same row among others);
- int8 against a float stack holding the dequantized weights ``1e-5``
  (the reference test's bound);
- the fused functionals ``1e-5`` (``1e-6`` where the reference test
  uses it).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.incubate.nn import FusedMultiTransformer as RefFMT
from paddle_tpu.incubate.nn import functional as RIF
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.nlp import load_paddle_tpu_arrays
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-5, atol=1e-5)
# (norm, activation, kv heads, neox)
CONFIGS = [("layernorm", "gelu", None, True),
           ("rmsnorm", "swiglu", 2, False),
           ("layernorm", "gelu", 2, False),
           ("rmsnorm", "swiglu", None, True)]


def _rnd(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._value, np.float32)


def _pair(norm, act, hk, neox, seed=0, layers=2):
    paddle.seed(seed)
    ref = RefFMT(64, 4, 128, num_layers=layers, norm_type=norm,
                 activation=act, num_key_value_heads=hk,
                 use_neox_rotary_style=neox)
    port = FusedMultiTransformer(64, 4, 128, num_layers=layers,
                                 norm_type=norm, activation=act,
                                 num_key_value_heads=hk,
                                 use_neox_rotary_style=neox, device="cpu")
    load_paddle_tpu_arrays(port, {k: np.asarray(v._value)
                                  for k, v in ref.state_dict().items()})
    return ref, port


def _run_both(ref, port, max_len=32):
    """Prefill of 8 tokens at offset 0, a chunked prefill of 4 at offset
    8, then 4 decode steps with per-row lengths (row 1 leaves its last 3
    slots out). Yields (label, port out, ref out, port caches, ref
    caches) after each call."""
    cr = ref.gen_cache(2, max_len)
    cp = port.gen_cache(2, max_len)
    calls = [(_rnd(1, 2, 8, 64), 0, None), (_rnd(2, 2, 4, 64), 8, None)]
    for i in range(4):
        off = 12 + i
        calls.append((_rnd(3 + i, 2, 1, 64), off,
                      np.array([off + 1, off - 2], np.int32)))
    with torch.no_grad():
        for x, off, lens in calls:
            kw = {} if lens is None else {"seq_lens": lens}
            out_r, cr = ref(paddle.to_tensor(x), caches=cr, time_step=off,
                            **{k: paddle.to_tensor(v) for k, v in kw.items()})
            out_p, cp = port(torch.from_numpy(x), caches=cp, time_step=off,
                             **{k: torch.from_numpy(v)
                                for k, v in kw.items()})
            yield f"offset {off} s {x.shape[1]}", out_p, out_r, cp, cr


@pytest.mark.parametrize("norm,act,hk,neox", CONFIGS)
def test_stack_matches_reference_f32(norm, act, hk, neox):
    ref, port = _pair(norm, act, hk, neox)
    x = _rnd(0, 2, 8, 64)
    with torch.no_grad():
        np.testing.assert_allclose(_np(port(torch.from_numpy(x))),
                                   _np(ref(paddle.to_tensor(x))), **TOL)
    for label, out_p, out_r, cp, cr in _run_both(ref, port):
        np.testing.assert_allclose(_np(out_p), _np(out_r), err_msg=label,
                                   **TOL)
        for a, b in zip(cp, cr):
            np.testing.assert_allclose(_np(a), _np(b), err_msg=label, **TOL)


@pytest.mark.parametrize("norm,act,hk,neox", CONFIGS[:2])
def test_weight_only_int8_matches_reference_int8(norm, act, hk, neox):
    ref, port = _pair(norm, act, hk, neox, seed=4)
    ref.quantize_weight_only()
    port.quantize_weight_only()
    assert port.quantize_weight_only() is port
    for name in ("qkv_weight", "linear_weight", "ffn1_weight",
                 "ffn2_weight"):
        w = getattr(port, name)
        assert w.dtype == torch.int8 and not w.requires_grad
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(getattr(ref, name)._value))
        np.testing.assert_array_equal(
            getattr(port, name + "_scale").numpy(),
            np.asarray(getattr(ref, name + "_scale")._value))
    for label, out_p, out_r, _, _ in _run_both(ref, port):
        np.testing.assert_allclose(_np(out_p), _np(out_r), err_msg=label,
                                   **TOL)
    # a quantized reference's arrays carry onto a quantized port stack
    fresh = FusedMultiTransformer(64, 4, 128, num_layers=2, norm_type=norm,
                                  activation=act, num_key_value_heads=hk,
                                  use_neox_rotary_style=neox,
                                  device="cpu").quantize_weight_only()
    load_paddle_tpu_arrays(fresh, {k: np.asarray(v._value)
                                   for k, v in ref.state_dict().items()})
    assert torch.equal(fresh.ffn1_weight, port.ffn1_weight)


def test_decode_matches_full_forward():
    """tests/test_incubate_inference.py's decode test on the port."""
    fmt = FusedMultiTransformer(
        64, 4, 128, num_layers=3, norm_type="rmsnorm", activation="swiglu",
        num_key_value_heads=2, device="cpu")
    x = torch.from_numpy(_rnd(0, 2, 8, 64))
    nxt = torch.from_numpy(_rnd(1, 2, 1, 64))
    with torch.no_grad():
        caches = fmt.gen_cache(2, 32)
        _, caches = fmt(x, caches=caches, time_step=0)
        out_dec, caches = fmt(nxt, caches=caches, time_step=8)
        out_full = fmt(torch.cat([x, nxt], dim=1))
    np.testing.assert_allclose(out_dec.numpy()[:, 0], out_full.numpy()[:, -1],
                               atol=1e-4)


def test_gelu_layernorm_shape():
    fmt = FusedMultiTransformer(32, 2, 64, num_layers=2, device="cpu")
    with torch.no_grad():
        out = fmt(torch.from_numpy(_rnd(0, 2, 4, 32)))
    assert out.shape == (2, 4, 32)
    assert [n for n, _ in fmt.named_parameters()][:3] == [
        "ln_scale", "ln_bias", "qkv_weight"]


def test_weight_only_int8_parity_with_dequantized_float():
    """tests/test_incubate_inference.py's int8 test on the port: the int8
    stack equals a float stack holding int8 * scale, prefill and decode."""
    def build():
        return FusedMultiTransformer(
            64, 4, 128, num_layers=3, norm_type="rmsnorm",
            activation="swiglu", num_key_value_heads=2, device="cpu",
            generator=torch.Generator().manual_seed(4))

    fmt_q = build().quantize_weight_only()
    assert fmt_q.qkv_weight.dtype == torch.int8
    fmt_ref = build()
    with torch.no_grad():
        for name in ("qkv_weight", "linear_weight", "ffn1_weight",
                     "ffn2_weight"):
            q = getattr(fmt_q, name).float()
            s = getattr(fmt_q, name + "_scale")
            getattr(fmt_ref, name).copy_(q * s[:, None, :])
        x = torch.from_numpy(_rnd(0, 2, 8, 64))
        cq, cr = fmt_q.gen_cache(2, 32), fmt_ref.gen_cache(2, 32)
        out_q, cq = fmt_q(x, caches=cq, time_step=0)
        out_r, cr = fmt_ref(x, caches=cr, time_step=0)
        np.testing.assert_allclose(out_q.numpy(), out_r.numpy(), rtol=1e-5,
                                   atol=1e-5)
        nxt = torch.from_numpy(_rnd(1, 2, 1, 64))
        dq, _ = fmt_q(nxt, caches=cq, time_step=8)
        dr, _ = fmt_ref(nxt, caches=cr, time_step=8)
    np.testing.assert_allclose(dq.numpy(), dr.numpy(), rtol=1e-5, atol=1e-5)


def test_tensor_parallel_refuses():
    for kw in ({"nranks": 2}, {"ring_id": 0}):
        with pytest.raises(NotImplementedError, match="A7"):
            FusedMultiTransformer(64, 4, 128, device="cpu", **kw)


# ------------------------------------------------------- fused functionals
def test_fused_norms_match_reference():
    x, w, b = _rnd(0, 2, 4, 8), _rnd(1, 8), _rnd(2, 8)
    res, bias = _rnd(3, 2, 4, 8), _rnd(4, 8)
    t = torch.from_numpy
    p = paddle.to_tensor
    # tests/test_incubate_inference.py's wrapper test on the port
    np.testing.assert_allclose(IF.fused_rms_norm(t(x), t(w)).numpy(),
                               F.rms_norm(t(x), t(w)).numpy(), atol=1e-6)
    out, r_out = IF.fused_rms_norm(t(x), t(w), residual=t(res), bias=t(bias))
    want, r_want = RIF.fused_rms_norm(p(x), p(w), residual=p(res),
                                      bias=p(bias))
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(r_out.numpy(), r_want.numpy(), **TOL)
    for axis in (-1, 1):
        got = IF.fused_layer_norm(t(x), t(w) if axis == -1 else None,
                                  t(b) if axis == -1 else None,
                                  begin_norm_axis=axis)
        want = RIF.fused_layer_norm(p(x), p(w) if axis == -1 else None,
                                    p(b) if axis == -1 else None,
                                    begin_norm_axis=axis)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    out, r_out = IF.fused_layer_norm(t(x), t(w), t(b), residual=t(res))
    want, r_want = RIF.fused_layer_norm(p(x), p(w), p(b), residual=p(res))
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(r_out.numpy(), r_want.numpy(), **TOL)


def test_fused_linear_and_bias_act_match_reference():
    x, w, b = _rnd(0, 3, 8), _rnd(1, 8, 5), _rnd(2, 5)
    t, p = torch.from_numpy, paddle.to_tensor
    np.testing.assert_allclose(
        IF.fused_linear(t(x), t(w), t(b)).numpy(),
        RIF.fused_linear(p(x), p(w), p(b)).numpy(), **TOL)
    wt = np.ascontiguousarray(w.T)
    np.testing.assert_allclose(
        IF.fused_linear(t(x), t(wt), t(b), transpose_weight=True).numpy(),
        RIF.fused_linear(p(x), p(wt), p(b), transpose_weight=True).numpy(),
        **TOL)
    xb = _rnd(3, 3, 5) * 3
    for act in ("gelu", "relu", "silu", "tanh"):
        np.testing.assert_allclose(
            IF.fused_bias_act(t(xb), t(b), act_method=act).numpy(),
            RIF.fused_bias_act(p(xb), p(b), act_method=act).numpy(),
            err_msg=act, **TOL)


@pytest.mark.parametrize("pre_ln,mask", [(True, False), (False, True)])
def test_fused_multi_head_attention_matches_reference(pre_ln, mask):
    e, h, d = 32, 2, 16
    x = _rnd(0, 2, 6, e)
    qkv_w, qkv_b = _rnd(1, 3, h, d, e) * 0.2, _rnd(2, 3, h, d)
    lin_w, lin_b = _rnd(3, h * d, e) * 0.2, _rnd(4, e)
    sc, bi = _rnd(5, e), _rnd(6, e)
    m = (np.tril(np.ones((6, 6), bool))[None, None] if mask else None)
    args = [x, qkv_w, lin_w]
    kw = dict(qkv_bias=qkv_b, linear_bias=lin_b)
    kw.update(pre_ln_scale=sc, pre_ln_bias=bi) if pre_ln else kw.update(
        ln_scale=sc, ln_bias=bi)
    got = IF.fused_multi_head_attention(
        *map(torch.from_numpy, args),
        attn_mask=None if m is None else torch.from_numpy(m),
        pre_layer_norm=pre_ln,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = RIF.fused_multi_head_attention(
        *map(paddle.to_tensor, args),
        attn_mask=None if m is None else paddle.to_tensor(m),
        pre_layer_norm=pre_ln,
        **{k: paddle.to_tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("act,pre_ln", [("relu", False), ("gelu", True)])
def test_fused_feedforward_matches_reference(act, pre_ln):
    e = 16
    x = _rnd(0, 2, 5, e)
    w1, b1, w2, b2 = (_rnd(1, e, 32) * 0.3, _rnd(2, 32), _rnd(3, 32, e) * 0.3,
                      _rnd(4, e))
    lns = {k: _rnd(5 + i, e) for i, k in enumerate(
        ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias"))}
    kw = dict(linear1_bias=b1, linear2_bias=b2, **lns)
    got = IF.fused_feedforward(
        *map(torch.from_numpy, (x, w1, w2)), dropout1_rate=0.0,
        dropout2_rate=0.0, activation=act, pre_layer_norm=pre_ln,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = RIF.fused_feedforward(
        *map(paddle.to_tensor, (x, w1, w2)), dropout1_rate=0.0,
        dropout2_rate=0.0, activation=act, pre_layer_norm=pre_ln,
        **{k: paddle.to_tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("neox", [True, False])
def test_fused_rotary_position_embedding_matches_reference(neox):
    q, k, v = _rnd(0, 2, 6, 2, 32), _rnd(1, 2, 6, 2, 32), _rnd(2, 2, 6, 2, 32)
    got = IF.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), None,
        use_neox_rotary_style=neox)
    want = RIF.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k), None,
        use_neox_rotary_style=neox)
    assert got[2] is None and want[2] is None
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    # duplicated-half (S, D) tables and position ids (the reference's
    # reshape refuses paddle's (1, S, 1, D) layout; the port takes both)
    ang = np.outer(np.arange(6), 1.0 / 10000 ** (np.arange(0, 32, 2) / 32))
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype("f4")
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype("f4")
    pos = np.array([[5, 4, 3, 2, 1, 0]] * 2)
    got = IF.fused_rotary_position_embedding(
        torch.from_numpy(q), sin=torch.from_numpy(sin),
        cos=torch.from_numpy(cos), position_ids=torch.from_numpy(pos),
        use_neox_rotary_style=neox)
    want = RIF.fused_rotary_position_embedding(
        paddle.to_tensor(q), sin=paddle.to_tensor(sin),
        cos=paddle.to_tensor(cos), position_ids=paddle.to_tensor(pos),
        use_neox_rotary_style=neox)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)
    four_d = IF.fused_rotary_position_embedding(
        torch.from_numpy(q), sin=torch.from_numpy(sin[None, :, None]),
        cos=torch.from_numpy(cos[None, :, None]),
        position_ids=torch.from_numpy(pos), use_neox_rotary_style=neox)
    assert torch.equal(four_d[0], got[0])
    assert F.fused_rotary_position_embedding is \
        IF.fused_rotary_position_embedding
    assert RF.fused_rotary_position_embedding is \
        RIF.fused_rotary_position_embedding
