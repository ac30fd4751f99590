"""The port's Llama stack (paddle_tpu_torch.nlp) held against paddle_tpu's:
the weight carry, no-cache logits, RMSNorm and rope.

Tolerances: model logits f32 ``1e-4`` (two decoder layers of f32
matmuls and softmaxes summed in another order than XLA's); unit ops f32
``1e-5``; the carry is byte-exact.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nn import functional as RF
from paddle_tpu.nn.functional.rope import (
    apply_rotary_emb as ref_apply_rotary_emb,
    build_rope_cache as ref_build_rope_cache,
)
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as F


def _ref_arrays(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _pair(seed=0, **overrides):
    paddle.seed(seed)
    ref = RefLM(RefConfig.tiny(**overrides))
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(**overrides), device="cpu")
    load_paddle_tpu_arrays(port, _ref_arrays(ref))
    port.eval()
    return ref, port


@pytest.mark.parametrize("tp", [True, False])
def test_weight_carry_round_trips_byte_exact(tp):
    paddle.seed(3)
    ref = RefLM(RefConfig.tiny(tensor_parallel=tp))
    arrays = _ref_arrays(ref)
    assert len(arrays) == 21
    port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=tp),
                            device="cpu")
    load_paddle_tpu_arrays(port, arrays)
    params = dict(port.named_parameters())
    assert list(params) == list(arrays)
    linear = {f"{n}.weight" for n, m in port.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for key, a in arrays.items():
        back = params[key].detach().numpy()
        # paddle's (in, out) Linear weight sits transposed in torch's
        # (out, in); transposing back must give the same bytes
        back = np.ascontiguousarray(back.T if key in linear else back)
        assert back.dtype == a.dtype and back.shape == a.shape
        assert back.tobytes() == a.tobytes(), key
    assert len(linear) == 15


def test_weight_carry_checks_every_key_and_shape():
    paddle.seed(4)
    arrays = _ref_arrays(RefLM(RefConfig.tiny(tensor_parallel=False)))
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    missing = dict(arrays)
    missing.pop("llama.norm.weight")
    with pytest.raises(KeyError, match="llama.norm.weight"):
        load_paddle_tpu_arrays(port, missing)
    extra = dict(arrays, **{"llama.extra.weight": np.zeros(3, "f4")})
    with pytest.raises(KeyError, match="llama.extra.weight"):
        load_paddle_tpu_arrays(port, extra)
    bad = dict(arrays)
    bad["lm_head.weight"] = np.zeros((128, 64), "f4")   # (out, in): wrong
    with pytest.raises(ValueError, match="lm_head.weight"):
        load_paddle_tpu_arrays(port, bad)


@pytest.mark.parametrize("overrides", [
    {},                                   # GQA 4/2, the tiny preset
    {"attention_bias": True},             # Qwen2-style q/k/v biases
    {"num_key_value_heads": 1},           # MQA
    {"num_key_value_heads": 4, "tensor_parallel": False},   # MHA, serial
    {"sliding_window": 8},                # Mistral-style band, K4's window
])
def test_no_cache_logits_match_reference(overrides):
    ref, port = _pair(seed=1, **overrides)
    if overrides.get("attention_bias"):
        # the reference initializes biases to zero: give them values
        rng = np.random.RandomState(9)
        arrays = _ref_arrays(ref)
        for key in arrays:
            if key.endswith("_proj.bias"):
                arrays[key] = rng.randn(*arrays[key].shape).astype("f4")
        ref.set_state_dict({k: paddle.to_tensor(v)
                            for k, v in arrays.items()})
        load_paddle_tpu_arrays(port, arrays)
    # 20 tokens: past a window of 8
    ids = np.random.RandomState(2).randint(0, 128, (2, 20)).astype("int64")
    want = np.asarray(ref(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_model_refuses_later_slices():
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        LlamaForCausalLM(LlamaConfig.tiny(context_parallel="ring"),
                         device="cpu")
    # the packed path's own refusals (the reference's ValueErrors)
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    cu = torch.tensor([0, 4])
    with pytest.raises(ValueError, match="mutually exclusive"):
        port(torch.zeros(1, 4, dtype=torch.long),
             caches=port.init_caches(1, 4), cu_seqlens=cu)
    with pytest.raises(ValueError, match="packed"):
        port(torch.zeros(2, 4, dtype=torch.long), cu_seqlens=cu)


def test_seeded_init_is_reproducible():
    cfg = LlamaConfig.tiny()
    a = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    b = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    for (ka, pa), (kb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(pa, pb)


@pytest.mark.parametrize("axis", [-1, 1])
def test_rms_norm_matches_reference(axis):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 16).astype("f4")
    w = rng.randn(*(x.shape[axis % 3:])).astype("f4")
    want = RF.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w),
                       begin_norm_axis=axis).numpy()
    got = F.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                     begin_norm_axis=axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    layer = RMSNorm(16, device="cpu")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.reshape(-1)[:16]))
        np.testing.assert_allclose(
            layer(torch.from_numpy(x)).numpy(),
            RF.rms_norm(paddle.to_tensor(x),
                        paddle.to_tensor(w.reshape(-1)[:16])).numpy(),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("neox", [True, False])
def test_rope_matches_reference(neox):
    cos_r, sin_r = ref_build_rope_cache(40, 16, base=500.0,
                                        position_offset=3)
    cos, sin = F.build_rope_cache(40, 16, base=500.0, position_offset=3)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_r), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_r), atol=1e-5)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 3, 16).astype("f4")
    pos = rng.randint(0, 40, (2, 5))
    want = ref_apply_rotary_emb(jnp.asarray(x), cos_r, sin_r, neox=neox,
                                position_ids=jnp.asarray(pos))
    got = F.apply_rotary_emb(torch.from_numpy(x), cos, sin, neox=neox,
                             position_ids=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = ref_apply_rotary_emb(jnp.asarray(x), cos_r[:5], sin_r[:5],
                                neox=neox)
    got = F.apply_rotary_emb(torch.from_numpy(x), cos[:5], sin[:5],
                             neox=neox)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
