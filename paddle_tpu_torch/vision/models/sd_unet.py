"""Stable-Diffusion-class conditional UNet and DDIM sampler (counterpart of
``paddle_tpu/vision/models/sd_unet.py``; config #5 of BASELINE.md).

The architecture, names and arithmetic are the reference's: GroupNorm,
3x3 convolutions (cuDNN on the card: the reference has no Pallas kernel
there), and per level ``CrossAttnBlock``s whose self- and cross-attention
go through the port's ``F.scaled_dot_product_attention`` (no mask): K4 on
the card for heads of 64 or 128, the plain path for narrower ones, as the
reference's gate sends them to XLA. Upsampling is nearest x2. Built on
``device`` (default ``cuda``) with weights drawn from ``generator``
(``models/_build.py``); cast with ``.to(dtype)``.

One rule the reference does not state: the timestep embedding is formed
in f32 (the reference's) and then cast to the model's dtype, so a bf16
model runs in bf16 throughout (in f32 the cast is the identity).

:func:`ddim_sample` is the reference's one-program denoising loop. The
reference compiles it with ``lax.fori_loop`` inside ``jit``, cached per
(scheduler, steps) on the UNet; the port keeps that cache
(``unet._ddim_loops``) and on CUDA captures the whole loop of UNet steps
as ONE CUDA graph (``_graphs.CapturedStep``): static latents, context,
timesteps and parameters, no host sync inside, every later call a
replay. On the CPU the same loop runs eagerly. A capture that fails
raises; there is no eager fallback on CUDA.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._device import resolve_device
from ..._graphs import CapturedStep
from ...nn import functional as F
from ...nn.layer.common import LayerList, Linear
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import GroupNorm, LayerNorm
from ...ops import _library as L
from ._build import seed_weights
from ...nn.layer.layers import Layer

__all__ = ["SDUNetConfig", "UNet2DConditionModel", "DDIMScheduler",
           "ddim_sample"]


class SDUNetConfig:
    def __init__(self, in_channels=4, out_channels=4,
                 block_out_channels=(32, 64), layers_per_block=1,
                 cross_attention_dim=64, attention_head_dim=8,
                 norm_num_groups=8, sample_size=16):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.cross_attention_dim = cross_attention_dim
        self.attention_head_dim = attention_head_dim
        self.norm_num_groups = norm_num_groups
        self.sample_size = sample_size

    @staticmethod
    def tiny(**overrides):
        cfg = dict(block_out_channels=(16, 32), cross_attention_dim=32,
                   attention_head_dim=8, norm_num_groups=4, sample_size=8)
        cfg.update(overrides)
        return SDUNetConfig(**cfg)


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal embedding (B,) -> (B, dim) in f32, cos before sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class ResnetBlock2D(Layer):
    def __init__(self, in_ch, out_ch, temb_ch, groups):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch)
        self.conv1 = Conv2D(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(groups, out_ch)
        self.conv2 = Conv2D(out_ch, out_ch, 3, padding=1)
        self.shortcut = (Conv2D(in_ch, out_ch, 1) if in_ch != out_ch
                         else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        skip = self.shortcut(x) if self.shortcut is not None else x
        return skip + h


class CrossAttnBlock(Layer):
    """Self-attention, cross-attention and an MLP over the flattened
    spatial tokens, each pre-LayerNorm with a residual."""

    def __init__(self, channels, ctx_dim, head_dim):
        super().__init__()
        self.num_heads = max(1, channels // head_dim)
        self.head_dim = channels // self.num_heads
        self.norm1 = LayerNorm(channels)
        self.to_q1 = Linear(channels, channels, bias=False)
        self.to_k1 = Linear(channels, channels, bias=False)
        self.to_v1 = Linear(channels, channels, bias=False)
        self.proj1 = Linear(channels, channels)
        self.norm2 = LayerNorm(channels)
        self.to_q2 = Linear(channels, channels, bias=False)
        self.to_k2 = Linear(ctx_dim, channels, bias=False)
        self.to_v2 = Linear(ctx_dim, channels, bias=False)
        self.proj2 = Linear(channels, channels)
        self.norm3 = LayerNorm(channels)
        self.ff1 = Linear(channels, channels * 4)
        self.ff2 = Linear(channels * 4, channels)

    def _attend(self, q, k, v, b, sq, sk):
        q = q.reshape(b, sq, self.num_heads, self.head_dim)
        k = k.reshape(b, sk, self.num_heads, self.head_dim)
        v = v.reshape(b, sk, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(q, k, v)
        return out.reshape(b, sq, self.num_heads * self.head_dim)

    def forward(self, x, context):
        b, c, h, w = x.shape
        tokens = x.reshape(b, c, h * w).transpose(1, 2)
        t = self.norm1(tokens)
        tokens = tokens + self.proj1(self._attend(
            self.to_q1(t), self.to_k1(t), self.to_v1(t), b, h * w, h * w))
        t = self.norm2(tokens)
        sk = context.shape[1]
        tokens = tokens + self.proj2(self._attend(
            self.to_q2(t), self.to_k2(context), self.to_v2(context), b,
            h * w, sk))
        t = self.norm3(tokens)
        tokens = tokens + self.ff2(F.gelu(self.ff1(t)))
        return tokens.transpose(1, 2).reshape(b, c, h, w)


class Downsample2D(Layer):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2D(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(Layer):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2D(ch, ch, 3, padding=1)

    def forward(self, x):
        # jax.image.resize's nearest at x2: source floor(i / 2)
        x = torch.nn.functional.interpolate(x, scale_factor=2.0,
                                            mode="nearest")
        return self.conv(x)


class UNet2DConditionModel(Layer):
    """Conditional UNet: down levels (res + cross-attn blocks, then a
    strided conv), the mid block, up levels over the skips (then nearest
    x2 and a conv)."""

    def __init__(self, config: SDUNetConfig = None, device=None,
                 generator=None, **kw):
        super().__init__()
        cfg = config or SDUNetConfig(**kw)
        self.config = cfg
        chans = cfg.block_out_channels
        temb_ch = chans[0] * 4
        g = cfg.norm_num_groups
        dev = resolve_device(device)
        with dev:
            self.time_embed_dim = chans[0]
            self.time_mlp1 = Linear(chans[0], temb_ch)
            self.time_mlp2 = Linear(temb_ch, temb_ch)
            self.conv_in = Conv2D(cfg.in_channels, chans[0], 3, padding=1)

            self.down_res = LayerList()
            self.down_attn = LayerList()
            self.downsamplers = LayerList()
            in_ch = chans[0]
            for level, out_ch in enumerate(chans):
                res_blocks, attn_blocks = LayerList(), LayerList()
                for _ in range(cfg.layers_per_block):
                    res_blocks.append(ResnetBlock2D(in_ch, out_ch, temb_ch,
                                                    g))
                    attn_blocks.append(CrossAttnBlock(
                        out_ch, cfg.cross_attention_dim,
                        cfg.attention_head_dim))
                    in_ch = out_ch
                self.down_res.append(res_blocks)
                self.down_attn.append(attn_blocks)
                self.downsamplers.append(
                    Downsample2D(out_ch) if level < len(chans) - 1
                    else torch.nn.Module())

            self.mid_res1 = ResnetBlock2D(chans[-1], chans[-1], temb_ch, g)
            self.mid_attn = CrossAttnBlock(
                chans[-1], cfg.cross_attention_dim, cfg.attention_head_dim)
            self.mid_res2 = ResnetBlock2D(chans[-1], chans[-1], temb_ch, g)

            self.up_res = LayerList()
            self.up_attn = LayerList()
            self.upsamplers = LayerList()
            rev = list(reversed(chans))
            in_ch = chans[-1]
            for level, out_ch in enumerate(rev):
                res_blocks, attn_blocks = LayerList(), LayerList()
                for i in range(cfg.layers_per_block + 1):
                    skip_ch = rev[min(level + (1 if i == cfg.layers_per_block
                                               else 0), len(rev) - 1)]
                    res_blocks.append(ResnetBlock2D(in_ch + skip_ch, out_ch,
                                                    temb_ch, g))
                    attn_blocks.append(CrossAttnBlock(
                        out_ch, cfg.cross_attention_dim,
                        cfg.attention_head_dim))
                    in_ch = out_ch
                self.up_res.append(res_blocks)
                self.up_attn.append(attn_blocks)
                self.upsamplers.append(
                    Upsample2D(out_ch) if level < len(rev) - 1
                    else torch.nn.Module())

            self.norm_out = GroupNorm(g, chans[0])
            self.conv_out = Conv2D(chans[0], cfg.out_channels, 3, padding=1)
        seed_weights(self, dev, generator)

    def forward(self, sample, timestep, encoder_hidden_states):
        temb = timestep_embedding(timestep, self.time_embed_dim).to(
            self.conv_in.weight.dtype)
        temb = self.time_mlp2(F.silu(self.time_mlp1(temb)))

        h = self.conv_in(sample)
        skips = [h]
        n_down = len(self.down_res)
        for level in range(n_down):
            for rb, ab in zip(self.down_res[level], self.down_attn[level]):
                h = rb(h, temb)
                h = ab(h, encoder_hidden_states)
                skips.append(h)
            if level < n_down - 1:
                h = self.downsamplers[level](h)
                skips.append(h)

        h = self.mid_res1(h, temb)
        h = self.mid_attn(h, encoder_hidden_states)
        h = self.mid_res2(h, temb)

        n_up = len(self.up_res)
        for level in range(n_up):
            for rb, ab in zip(self.up_res[level], self.up_attn[level]):
                h = rb(torch.cat([h, skips.pop()], dim=1), temb)
                h = ab(h, encoder_hidden_states)
            if level < n_up - 1:
                h = self.upsamplers[level](h)

        return self.conv_out(F.silu(self.norm_out(h)))


class DDIMScheduler:
    """Deterministic DDIM (eta = 0) over the scaled-linear beta schedule;
    ``alphas_cumprod`` in f32 as the reference forms it (``linspace`` of
    the square roots, squared, ``cumprod`` of ``1 - beta``)."""

    def __init__(self, num_train_timesteps=1000, beta_start=0.00085,
                 beta_end=0.012):
        f32 = np.float32
        # jnp.linspace's f32 formula: start * (1 - i/div) + stop * i/div
        div = num_train_timesteps - 1
        step = np.arange(div, dtype=f32) / f32(div)
        lo, hi = f32(beta_start ** 0.5), f32(beta_end ** 0.5)
        roots = np.append(lo * (f32(1.0) - step) + hi * step, hi)
        betas = (roots * roots).astype(f32)
        self.alphas_cumprod = np.cumprod(f32(1.0) - betas, dtype=f32)
        self.num_train_timesteps = num_train_timesteps

    def timesteps(self, num_inference_steps):
        if num_inference_steps > self.num_train_timesteps:
            raise ValueError(
                f"num_inference_steps ({num_inference_steps}) must be <= "
                f"num_train_timesteps ({self.num_train_timesteps})")
        step = self.num_train_timesteps // num_inference_steps
        return np.arange(self.num_train_timesteps - 1, -1, -step,
                         dtype=np.int32)[:num_inference_steps]

    def step_coefficients(self, num_inference_steps):
        """Per step ``(t, sqrt(1 - a_t), sqrt(a_t), sqrt(a_prev),
        sqrt(1 - a_prev))`` as f32 values (``a_prev`` = 1 after the last
        step), the reference's update ``x0 = (x - sqrt(1 - a_t) * eps) /
        sqrt(a_t); x <- sqrt(a_prev) * x0 + sqrt(1 - a_prev) * eps``."""
        ts = self.timesteps(num_inference_steps)
        acp = self.alphas_cumprod
        one = np.float32(1.0)
        out = []
        for i, t in enumerate(ts):
            a_t = acp[t]
            a_prev = acp[ts[i + 1]] if i + 1 < len(ts) else one
            out.append((int(t), float(np.sqrt(one - a_t)),
                        float(np.sqrt(a_t)), float(np.sqrt(a_prev)),
                        float(np.sqrt(one - a_prev))))
        return out


_DEFAULT_SCHEDULER = None
# the eager oracle on CUDA (tests and chip_smoke.py hold the captured
# sampler to it): the cached loop runs its body eagerly, uncaptured
_EAGER = False


class _DDIMLoop:
    """One cached sampler: the loop of UNet steps over static latents and
    context buffers, eager on the CPU and one captured CUDA graph on the
    card (warmed up on the capture stream by its first call, which gives
    that call's answer; every later call is a replay)."""

    def __init__(self, unet, scheduler, steps, latents, ctx):
        self.unet = unet
        self.scheduler = scheduler  # held: the key is its table's id
        self.coeffs = scheduler.step_coefficients(steps)
        self.lat = torch.empty_like(latents)
        self.ctx = torch.empty_like(ctx)
        b = latents.shape[0]
        self.t = [torch.full((b,), c[0], dtype=torch.int32,
                             device=latents.device) for c in self.coeffs]
        self.out = torch.empty_like(latents)
        self.graph = (CapturedStep(self.loop, latents.device)
                      if latents.device.type == "cuda" else None)

    def loop(self):
        lat = self.lat
        for t, (_, c1, c2, c3, c4) in zip(self.t, self.coeffs):
            eps = self.unet(lat, t, self.ctx).float()
            x0 = (lat.float() - c1 * eps) / c2
            lat = (c3 * x0 + c4 * eps).to(self.lat.dtype)
        self.out.copy_(lat)

    def __call__(self, latents, ctx):
        self.lat.copy_(latents)
        self.ctx.copy_(ctx)
        with torch.no_grad():
            if self.graph is None or _EAGER:
                self.loop()
            elif self.graph.graph is None:
                self.graph.warm_up()
                self.graph.capture()
            else:
                self.graph.replay()
        return self.out.clone()


def ddim_sample(unet, latents, encoder_hidden_states, scheduler=None,
                num_inference_steps=10):
    """The whole denoising loop: ``num_inference_steps`` UNet calls and
    DDIM updates (in f32, the latents kept in their dtype between steps),
    one CUDA graph on the card. Cached on ``unet._ddim_loops`` by the
    scheduler's table, the step count, the inputs' shapes, dtype and
    device, whether ``ops.plain_versions()`` is active, the f32 matmul
    and convolution precisions and the addresses of the parameters and
    buffers (a graph is fixed to all of them)."""
    global _DEFAULT_SCHEDULER
    if scheduler is None:
        if _DEFAULT_SCHEDULER is None:
            _DEFAULT_SCHEDULER = DDIMScheduler()
        scheduler = _DEFAULT_SCHEDULER  # stable identity -> cache hits
    cache = unet.__dict__.setdefault("_ddim_loops", {})
    key = (id(scheduler.alphas_cumprod), num_inference_steps,
           tuple(latents.shape), tuple(encoder_hidden_states.shape),
           latents.dtype, latents.device, L._plain,
           torch.get_float32_matmul_precision(),
           torch.backends.cudnn.allow_tf32,
           tuple(t.data_ptr() for t in unet.parameters()),
           tuple(t.data_ptr() for t in unet.buffers()))
    if key not in cache:
        cache[key] = _DDIMLoop(unet, scheduler, num_inference_steps,
                               latents, encoder_hidden_states)
    return cache[key](latents, encoder_hidden_states)
