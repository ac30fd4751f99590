"""The port's SD UNet (BASELINE config #5) and DDIM sampler held against
paddle_tpu's on the CPU, and the SDPA head-width gate it relies on. The
reference builds each UNet from its seed and its ``state_dict()`` is
carried with ``vision.load_paddle_tpu_arrays``; latents, timesteps and
context come from ``np.random.RandomState``.

Tolerances, each with its reason:
- f32 UNet forward: ``1e-5`` of the largest |output| plus ``1e-5``
  relative (the same GroupNorms, convolutions and products summed in other
  orders);
- the D = 64 variant, where the reference runs its Pallas flash kernel in
  interpret mode and the port K4's plain version: ``1e-5`` of the largest
  |output| plus ``1e-4`` relative (both flash forms renormalise their
  softmax in f32, in other orders than a plain softmax);
- ``alphas_cumprod``: ``1e-5`` relative (an f32 product of 1,000 terms:
  XLA may contract the linspace's multiply-add (its betas differ in the
  last bit) and multiplies the cumulative product in a tree order where
  numpy goes left to right; about ``2e-6`` apart at the end);
- three DDIM steps: ``1e-4`` of the largest |latent| (three f32 UNet
  calls whose differences pass through ``1 / sqrt(alpha_t)``, up to 15 at
  the first step);
- SDPA at D < 64: ``1e-6`` (the same f32 einsums and softmax).
"""
import importlib
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.vision.models import DDIMScheduler as RefScheduler
from paddle_tpu.vision.models import SDUNetConfig as RefConfig
from paddle_tpu.vision.models import UNet2DConditionModel as RefUNet
from paddle_tpu.vision.models import ddim_sample as ref_ddim_sample
from paddle_tpu_torch import vision
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention as port_attention
from paddle_tpu_torch.vision.models import (DDIMScheduler, SDUNetConfig,
                                            UNet2DConditionModel,
                                            ddim_sample)

# the module (``paddle_tpu_torch.ops`` re-exports its function by name)
port_flash = importlib.import_module("paddle_tpu_torch.ops.flash_attention")


def _pair(seed=0, **overrides):
    paddle.seed(seed)
    ref = RefUNet(RefConfig.tiny(**overrides))
    port = UNet2DConditionModel(SDUNetConfig.tiny(**overrides), device="cpu")
    vision.load_paddle_tpu_arrays(
        port, {k: np.asarray(v._value, np.float32)
               for k, v in ref.state_dict().items()})
    ref.eval()
    port.eval()
    return ref, port


def _inputs(cfg, b=2, ctx_len=6, seed=0):
    rng = np.random.RandomState(seed)
    lat = rng.randn(b, cfg.in_channels, cfg.sample_size,
                    cfg.sample_size).astype(np.float32)
    ctx = rng.randn(b, ctx_len, cfg.cross_attention_dim).astype(np.float32)
    return lat, ctx


def _close_to_max(got, want, rel, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel * float(np.abs(want).max()))


def test_tiny_forward_matches_reference():
    ref, port = _pair()
    lat, ctx = _inputs(port.config)
    t = np.array([10, 500], np.int32)
    want = np.asarray(ref(paddle.to_tensor(lat), paddle.to_tensor(t),
                          paddle.to_tensor(ctx))._value)
    with torch.no_grad():
        got = port(torch.from_numpy(lat), torch.from_numpy(t),
                   torch.from_numpy(ctx)).numpy()
    assert got.shape == lat.shape
    _close_to_max(got, want, 1e-5, 1e-5)
    names = [n for n, _ in port.named_parameters()]
    assert "down_attn.0.0.to_q1.weight" in names
    assert "up_res.1.0.norm1.weight" in names


def test_head_dim_64_reaches_both_flash_kernels(monkeypatch):
    """attention_head_dim=64 at tiny widths: the reference's Pallas flash
    kernel (FLAGS_pallas_force, interpret mode) and the port's K4 plain
    version, for every self- and cross-attention (7 blocks, 14 calls)."""
    import paddle_tpu.nn.functional.attention as ref_attention

    kw = dict(block_out_channels=(64, 128), attention_head_dim=64,
              cross_attention_dim=32, norm_num_groups=8)
    ref, port = _pair(**kw)
    lat, ctx = _inputs(port.config, ctx_len=5, seed=1)
    t = np.array([999, 20], np.int32)
    hits = {"ref": 0, "port": 0}
    real_ref, real_port = ref_attention._pallas_flash, \
        port_flash.flash_attention_plain

    def ref_spy(*a, **k):
        hits["ref"] += 1
        return real_ref(*a, **k)

    def port_spy(*a, **k):
        hits["port"] += 1
        return real_port(*a, **k)

    monkeypatch.setattr(ref_attention, "_pallas_flash", ref_spy)
    monkeypatch.setattr(port_flash, "flash_attention_plain", port_spy)
    paddle.set_flags({"FLAGS_pallas_force": True})
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)  # no fallback
            want = np.asarray(ref(paddle.to_tensor(lat),
                                  paddle.to_tensor(t),
                                  paddle.to_tensor(ctx))._value)
    finally:
        paddle.set_flags({"FLAGS_pallas_force": False})
    with torch.no_grad():
        got = port(torch.from_numpy(lat), torch.from_numpy(t),
                   torch.from_numpy(ctx)).numpy()
    assert hits == {"ref": 14, "port": 14}
    _close_to_max(got, want, 1e-5, 1e-4)


def test_scheduler_matches_reference():
    ref, port = RefScheduler(), DDIMScheduler()
    assert port.alphas_cumprod.dtype == np.float32
    np.testing.assert_allclose(port.alphas_cumprod,
                               np.asarray(ref.alphas_cumprod), rtol=1e-5)
    for n in (3, 20, 50):
        np.testing.assert_array_equal(port.timesteps(n), ref.timesteps(n))
    with pytest.raises(ValueError, match="num_inference_steps"):
        DDIMScheduler(num_train_timesteps=10).timesteps(20)


def test_ddim_sample_matches_reference_jitted_loop():
    ref, port = _pair(seed=2)
    lat, ctx = _inputs(port.config, seed=3)
    want = np.asarray(ref_ddim_sample(ref, paddle.to_tensor(lat),
                                      paddle.to_tensor(ctx),
                                      num_inference_steps=3)._value)
    got = ddim_sample(port, torch.from_numpy(lat), torch.from_numpy(ctx),
                      num_inference_steps=3).numpy()
    assert got.shape == lat.shape and np.isfinite(got).all()
    _close_to_max(got, want, 1e-4, 0)


def test_ddim_loop_cached_across_calls():
    """The twin of the reference's test of the same name: one cached loop
    for repeated calls; a new shape (a graph is fixed to its shapes) or
    step count adds one."""
    _, port = _pair()
    lat, ctx = _inputs(port.config)
    lat, ctx = torch.from_numpy(lat), torch.from_numpy(ctx)
    first = ddim_sample(port, lat, ctx, num_inference_steps=3)
    cache = port._ddim_loops
    assert len(cache) == 1
    again = ddim_sample(port, lat, ctx, num_inference_steps=3)
    assert len(cache) == 1  # the same loop reused
    assert torch.equal(first, again)
    ddim_sample(port, lat[:1], ctx[:1], num_inference_steps=3)
    ddim_sample(port, lat, ctx, num_inference_steps=2)
    assert len(cache) == 3


@pytest.mark.parametrize("d,causal", [(16, True), (8, False), (32, False)])
def test_sdpa_under_64_takes_the_xla_path(monkeypatch, d, causal):
    """The reference's gate: D < 64 goes to its XLA attention on every
    backend, and to the port's ``_xla_attention`` (not the flash
    function) on every device."""
    rng = np.random.RandomState(d)
    q = rng.randn(2, 9, 4, d).astype(np.float32)
    k = rng.randn(2, 7 if not causal else 9, 2, d).astype(np.float32)
    v = rng.randn(*k.shape).astype(np.float32)
    calls = []
    real = port_attention._xla_attention
    monkeypatch.setattr(port_attention, "_xla_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=causal)
    want = RF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), is_causal=causal)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               rtol=1e-6, atol=1e-6)
    if causal:
        got = F.sliding_window_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), 3)
        want = RF.sliding_window_attention(
            *(paddle.to_tensor(a) for a in (q, k, v)), 3)
        assert calls == [1, 1]
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   rtol=1e-6, atol=1e-6)


def test_sdpa_at_64_keeps_the_flash_function():
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    out = F.scaled_dot_product_attention(q, q, q)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
