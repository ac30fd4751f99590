"""The port's quantization module held against ``paddle_tpu.nn.quant`` on the
same seeded numpy inputs: the quantizers byte for byte (f32 and bf16), the
weight-only int8 Linear within f32 ``2e-5``, the serving sweep on
``LlamaConfig.tiny()`` (the same int8 weights and scales, logits within
``2e-5``), and the carry of a quantized reference model's arrays."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nn import quant as ref_quant
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.nn import quant

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """(numpy f32 view, torch bf16, jnp bf16) of the same bf16 values."""
    t = _t(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _weights(rng, shape):
    """Weights spanning six decades per channel, with a zero channel and
    values on .5 quant boundaries (where rounding half to even shows)."""
    w = rng.randn(*shape) * 10.0 ** rng.uniform(-3, 3, (1, shape[1]))
    w[:, 0] = 0.0
    w[:4, 1] = [127.0, 0.5, -1.5, 2.5]
    return w.astype("f4")


def test_weight_quantize_byte_equal_f32():
    w = _weights(np.random.RandomState(0), (24, 12))
    want_q, want_s = ref_quant.weight_quantize(paddle.to_tensor(w))
    got_q, got_s = quant.weight_quantize(_t(w))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q.numpy())
    np.testing.assert_array_equal(got_s.numpy(), want_s.numpy())
    # the stacked form per layer and the (in, out) layout's transpose
    ws = np.stack([w, w[::-1] * 3])
    rq, rs = ref_quant.weight_quantize_stacked(jnp.asarray(ws), axis=1)
    pq, ps = quant.weight_quantize_stacked(_t(ws), axis=1)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    tq, ts = quant.weight_quantize_stacked(_t(w.T.copy()), axis=1)
    np.testing.assert_array_equal(tq.numpy().T, want_q.numpy())
    np.testing.assert_array_equal(ts.numpy(), want_s.numpy())
    back = quant.weight_dequantize(got_q, got_s)
    np.testing.assert_array_equal(
        back.numpy(), ref_quant.weight_dequantize(want_q, want_s).numpy())


def test_weight_quantize_byte_equal_bf16():
    """The scale and ``w / scale`` are taken in bf16, as the reference
    takes them in the weight's dtype; only the scale's result is f32."""
    w = _weights(np.random.RandomState(1), (32, 16))
    wt, wj = _bf16(w)
    rq, rs = ref_quant.weight_quantize_stacked(wj, axis=0)
    pq, ps = quant.weight_quantize_stacked(wt, axis=0)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    # not the f32 algorithm: the bf16 scale differs from the f32 one
    fs = quant.weight_quantize_stacked(wt.float(), axis=0)[1]
    assert not torch.equal(fs, ps)


@pytest.mark.parametrize("bf16", [False, True])
def test_quantize_kv_rows_byte_equal(bf16):
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 4, 2, 16)
         * 10.0 ** rng.uniform(-4, 4, (3, 4, 2, 1))).astype("f4")
    x[0, 0] = 0.0
    xt, xj = _bf16(x) if bf16 else (_t(x), jnp.asarray(x))
    rq, rs = ref_quant.quantize_kv_rows(xj)
    pq, ps = quant.quantize_kv_rows(xt)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    # row locality: a sub-slab quantizes to the same rows
    sq, ss = quant.quantize_kv_rows(xt[1:2])
    assert torch.equal(sq, pq[1:2]) and torch.equal(ss, ps[1:2])


def test_weight_only_linear_and_quantized_linear_match_reference():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 32).astype("f4")
    w = rng.randn(32, 16).astype("f4")
    b = rng.randn(16).astype("f4")
    rq, rs = ref_quant.weight_quantize(paddle.to_tensor(w))
    want = ref_quant.weight_only_linear(paddle.to_tensor(x), rq,
                                        paddle.to_tensor(b), rs).numpy()
    pq, ps = quant.weight_quantize(_t(w))
    got = quant.weight_only_linear(_t(x), pq, _t(b), ps)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="weight_scale"):
        quant.weight_only_linear(_t(x), pq)
    # the layer: from a float Linear holding the same (transposed) weight
    lin = torch.nn.Linear(32, 16)
    with torch.no_grad():
        lin.weight.copy_(_t(w.T.copy()))
        lin.bias.copy_(_t(b))
    ql = quant.QuantizedLinear.from_linear(lin)
    assert ql.quant_weight.dtype == torch.int8
    assert not ql.quant_weight.requires_grad
    assert not ql.weight_scale.requires_grad
    assert tuple(ql.quant_weight.shape) == (16, 32)
    np.testing.assert_array_equal(ql.quant_weight.numpy().T, rq.numpy())
    np.testing.assert_allclose(ql(_t(x)).detach().numpy(), want, **TOL)
    # a float Linear holding the dequantized product is the same function
    deq = torch.nn.Linear(32, 16)
    with torch.no_grad():
        deq.weight.copy_(ql.dequantized_weight(torch.float32))
        deq.bias.copy_(_t(b))
    assert torch.equal(deq(_t(x)), ql(_t(x)))


@pytest.mark.parametrize("bias", [False, True])
def test_weight_only_linear_same_call_in_both_packages(bias):
    """One ``weight_quantize`` -> ``weight_only_linear`` call, written the
    same in both packages, on a non-square (in, out) weight: the same int8
    weight and scales, and outputs within f32 rounding."""
    rng = np.random.RandomState(7)
    x = rng.randn(5, 48).astype("f4")
    w = _weights(rng, (48, 20))
    b = rng.randn(20).astype("f4") if bias else None
    rq, rs = ref_quant.weight_quantize(paddle.to_tensor(w))
    want = ref_quant.weight_only_linear(
        paddle.to_tensor(x), rq, None if b is None else paddle.to_tensor(b),
        rs).numpy()
    pq, ps = quant.weight_quantize(_t(w))
    assert tuple(pq.shape) == (48, 20) and tuple(ps.shape) == (20,)
    np.testing.assert_array_equal(pq.numpy(), rq.numpy())
    got = quant.weight_only_linear(_t(x), pq, None if b is None else _t(b),
                                   ps)
    assert tuple(got.shape) == (5, 20)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-5 * scale)


def test_quantized_linear_bf16_bias_keeps_the_weight_dtype():
    """A deliberate difference (ROADMAP queue C): the port's bf16
    QuantizedLinear keeps its bias in bf16 and returns bf16, where the
    reference's f32 bias makes it return f32 (bf16 q/k/v must meet bf16
    KV pools in the attention kernels). The values agree with the
    reference's f32 output within one bf16 step of the largest |y|."""
    rng = np.random.RandomState(8)
    x = _t(rng.randn(6, 32).astype("f4")).to(torch.bfloat16)
    w = rng.randn(32, 24).astype("f4")
    b = _t(rng.randn(24).astype("f4")).to(torch.bfloat16)
    rq, rs = ref_quant.weight_quantize(paddle.to_tensor(w))
    ref = ref_quant.QuantizedLinear(32, 24)
    ref.quant_weight.set_value(rq)
    ref.weight_scale.set_value(rs)
    ref.bias.set_value(paddle.to_tensor(b.float().numpy()))
    want = ref(paddle.to_tensor(x.float().numpy()).astype("bfloat16"))
    assert str(want.dtype).endswith("float32")
    ql = quant.QuantizedLinear(32, 24, dtype=torch.bfloat16)
    with torch.no_grad():
        ql.quant_weight.copy_(_t(rq.numpy().T.copy()))
        ql.weight_scale.copy_(_t(rs.numpy().copy()))
        ql.bias.copy_(b)
    got = ql(x)
    assert got.dtype == torch.bfloat16 and ql.bias.dtype == torch.bfloat16
    want = want.numpy().astype("f4")
    step = 2.0 ** -8
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=step,
                               atol=step * float(np.abs(want).max()))


def test_fake_quant_and_linear_quantizers_match_reference():
    x = np.linspace(-2, 2, 64).astype("f4")
    want = ref_quant.fake_quantize_dequantize_abs_max(paddle.to_tensor(x))
    xt = _t(x).requires_grad_()
    got = quant.fake_quantize_dequantize_abs_max(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    got.sum().backward()       # straight-through: the gradient is one
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones(64, "f4"))
    rng = np.random.RandomState(0)
    w = rng.randn(16, 8).astype("f4")
    s = (np.abs(w).max(axis=0) / 127.0).astype("f4")
    rq = ref_quant.quantize_linear(paddle.to_tensor(w), paddle.to_tensor(s),
                                   axis=1)
    pq = quant.quantize_linear(_t(w), _t(s), axis=1)
    np.testing.assert_array_equal(pq.numpy(), rq.numpy())
    np.testing.assert_array_equal(
        quant.dequantize_linear(pq, _t(s), axis=1).numpy(),
        ref_quant.dequantize_linear(rq, paddle.to_tensor(s),
                                    axis=1).numpy())


def test_later_slices_raise_with_their_roadmap_item():
    z = torch.zeros(2, 2)
    with pytest.raises(NotImplementedError, match="A3"):
        quant.a8w8_linear(z, z, 1.0, torch.ones(2))
    with pytest.raises(NotImplementedError, match="A3"):
        quant.QuantizedLinear.from_linear(torch.nn.Linear(2, 2),
                                          act_scale=0.1)
    for cls in (quant.QuantizedColumnParallelLinear,
                quant.QuantizedRowParallelLinear):
        with pytest.raises(NotImplementedError, match="A7"):
            cls(2, 2)
    with pytest.raises(ValueError, match="algo"):
        quant.quantize_for_serving(torch.nn.Linear(2, 2), algo="fp8")
    with pytest.raises(ValueError, match="algo"):
        quant.weight_quantize(z, algo="fp8")


@pytest.fixture(scope="module")
def tiny_pair():
    paddle.seed(0)
    ref = RefLM(RefConfig.tiny(tensor_parallel=False))
    ref.eval()
    arrays = {k: v.numpy() for k, v in ref.state_dict().items()}
    port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                            device="cpu")
    load_paddle_tpu_arrays(port, arrays)
    return ref, port


@pytest.mark.parametrize("algo", ["weight_only_int8", "llm.int8"])
def test_quantize_for_serving_matches_reference_sweep(tiny_pair, algo):
    """Every Linear (q/k/v/o, the MLP, the lm-head) becomes int8 with the
    reference's weights and scales; embeddings and norms stay float; a
    second sweep changes nothing; the logits agree within f32."""
    import copy

    ref, port = copy.deepcopy(tiny_pair[0]), copy.deepcopy(tiny_pair[1])
    ref_quant.quantize_for_serving(ref, algo=algo)
    assert quant.quantize_for_serving(port, algo=algo) is port
    assert not any(isinstance(m, torch.nn.Linear) for m in port.modules())
    assert isinstance(port.lm_head, quant.QuantizedLinear)
    assert port.llama.embed_tokens.weight.dtype == torch.float32
    ref_sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    port_sd = dict(port.named_parameters())
    assert set(ref_sd) == set(port_sd)
    for key, want in ref_sd.items():
        got = port_sd[key].detach().numpy()
        if key.endswith("quant_weight"):
            got = got.T
        np.testing.assert_array_equal(got, want, err_msg=key)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    quant.quantize_for_serving(port, algo=algo)
    assert all(torch.equal(before[k], v)
               for k, v in port.state_dict().items())
    ids = np.random.RandomState(2).randint(1, 128, (2, 9)).astype(np.int32)
    want = ref(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = port(_t(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_carry_of_a_quantized_reference_model(tiny_pair):
    """``load_paddle_tpu_arrays`` takes a quantized reference model's
    arrays (``quant_weight`` transposed like a Linear weight,
    ``weight_scale`` as it is) byte for byte into a quantized port model,
    which then gives the reference's logits."""
    import copy

    ref = copy.deepcopy(tiny_pair[0])
    ref_quant.quantize_for_serving(ref)
    arrays = {k: v.numpy() for k, v in ref.state_dict().items()}
    port = quant.quantize_for_serving(LlamaForCausalLM(
        LlamaConfig.tiny(tensor_parallel=False), device="cpu",
        generator=torch.Generator().manual_seed(5)))
    load_paddle_tpu_arrays(port, arrays)
    qk = port.llama.layers[0].self_attn.q_proj
    np.testing.assert_array_equal(
        qk.quant_weight.numpy().T,
        arrays["llama.layers.0.self_attn.q_proj.quant_weight"])
    np.testing.assert_array_equal(
        qk.weight_scale.numpy(),
        arrays["llama.layers.0.self_attn.q_proj.weight_scale"])
    ids = np.random.RandomState(3).randint(1, 128, (1, 7)).astype(np.int32)
    with torch.no_grad():
        got = port(_t(ids).long()).numpy()
    np.testing.assert_allclose(got, ref(paddle.to_tensor(ids)).numpy(),
                               **TOL)
