"""Llama-family model in PyTorch (counterpart of ``paddle_tpu/nlp/llama.py``).

Module names mirror the reference's, so its ``state_dict()`` keys map
one to one onto this model's (see ``nlp/convert.py``). ``torch.nn.Linear``
stores its weight as (out, in) where the reference stores (in, out); the
carry transposes once. Both of the reference's builds, tensor-parallel
(Column/RowParallelLinear, which degrade to serial layers without a mesh)
and serial, give the same keys and shapes, so one port covers both.

Attention without a cache runs through the varlen kernel (K3) with one
segment per batch row; RMSNorm through K1. The serving path (paged KV
pool) lives in ``serving/engine.py`` and ``incubate/nn/functional``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from ..nn import functional as F
from ..nn.functional.rope import apply_rotary_emb, build_rope_cache
from ..nn.layer.norm import RMSNorm
from ..ops.varlen_flash_attention import varlen_flash_attention

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM"]

# the dtypes the port's kernels take
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LlamaConfig:
    """Configuration; the same fields and presets as the reference's."""

    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-6,
                 rope_theta=10000.0, tie_word_embeddings=False,
                 tensor_parallel=True, sequence_parallel=False,
                 context_parallel=None, use_recompute=False,
                 recompute_granularity="full", dtype="float32",
                 fuse_linear_cross_entropy=False, lce_chunk_rows=1024,
                 sliding_window=None, attention_bias=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        # without a device mesh the reference's tensor-parallel layers are
        # serial layers with the same parameters; the port has no mesh yet
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.context_parallel = context_parallel
        self.use_recompute = use_recompute
        self.recompute_granularity = recompute_granularity
        self.dtype = dtype
        self.fuse_linear_cross_entropy = fuse_linear_cross_entropy
        self.lce_chunk_rows = lce_chunk_rows
        self.sliding_window = sliding_window
        self.attention_bias = attention_bias

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported model dtype {self.dtype!r}")
        return _DTYPES[self.dtype]

    @staticmethod
    def llama2_7b(**overrides):
        cfg = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                   num_hidden_layers=32, num_attention_heads=32,
                   max_position_embeddings=4096)
        cfg.update(overrides)
        return LlamaConfig(**cfg)

    @staticmethod
    def tiny(**overrides):
        """Test-scale config, the reference's ``LlamaConfig.tiny``."""
        cfg = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=256)
        cfg.update(overrides)
        return LlamaConfig(**cfg)

    @staticmethod
    def mistral_7b(**overrides):
        """Mistral-7B shape: GQA 32/8 + sliding window 4096."""
        cfg = dict(vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=8,
                   max_position_embeddings=32768, rope_theta=10000.0,
                   sliding_window=4096)
        cfg.update(overrides)
        return LlamaConfig(**cfg)

    @staticmethod
    def qwen2_7b(**overrides):
        """Qwen2-7B shape: GQA 28/4 with q/k/v biases."""
        cfg = dict(vocab_size=152064, hidden_size=3584,
                   intermediate_size=18944, num_hidden_layers=28,
                   num_attention_heads=28, num_key_value_heads=4,
                   max_position_embeddings=32768, rope_theta=1000000.0,
                   attention_bias=True)
        cfg.update(overrides)
        return LlamaConfig(**cfg)


def _check_ported(config):
    """Refuse the options whose code paths belong to later slices."""
    later = {
        "sliding_window": ("sliding-window attention", "ROADMAP A3"),
        "use_recompute": ("recompute", "ROADMAP A11"),
        "context_parallel": ("context parallelism", "ROADMAP A12"),
        "fuse_linear_cross_entropy": ("the fused lm-head loss",
                                      "ROADMAP A11"),
    }
    for field, (what, item) in later.items():
        if getattr(config, field):
            raise NotImplementedError(
                f"{what} ({field}) is not ported yet ({item})")


class LlamaAttention(nn.Module):
    """Self-attention with rotary embedding, GQA and Qwen2-style q/k/v
    biases. The no-cache forward attends through the varlen kernel."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        h, hk, d = (config.num_attention_heads, config.num_key_value_heads,
                    config.head_dim)
        self.num_heads, self.num_kv_heads, self.head_dim = h, hk, d
        bias = bool(config.attention_bias)
        kw = dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(config.hidden_size, h * d, bias=bias, **kw)
        self.k_proj = nn.Linear(config.hidden_size, hk * d, bias=bias, **kw)
        self.v_proj = nn.Linear(config.hidden_size, hk * d, bias=bias, **kw)
        self.o_proj = nn.Linear(h * d, config.hidden_size, bias=False, **kw)

    def forward(self, hidden, position_offset=0):
        b, s, _ = hidden.shape
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(hidden).view(b, s, h, d)
        k = self.k_proj(hidden).view(b, s, hk, d)
        v = self.v_proj(hidden).view(b, s, hk, d)
        cos, sin = build_rope_cache(s, d, base=self.config.rope_theta,
                                    position_offset=position_offset,
                                    device=hidden.device)
        q = apply_rotary_emb(q, cos, sin)
        k = apply_rotary_emb(k, cos, sin)
        # one varlen segment per batch row = dense causal attention
        cu = torch.arange(0, (b + 1) * s, s, dtype=torch.int32,
                          device=hidden.device)
        out = varlen_flash_attention(
            q.reshape(b * s, h, d), k.reshape(b * s, hk, d),
            v.reshape(b * s, hk, d).contiguous(), cu, cu, causal=True,
            sm_scale=1.0 / math.sqrt(d))
        return self.o_proj(out.reshape(b, s, h * d))


class LlamaMLP(nn.Module):
    """SwiGLU MLP: down(silu(gate(x)) * up(x))."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(config.hidden_size,
                                   config.intermediate_size, **kw)
        self.up_proj = nn.Linear(config.hidden_size,
                                 config.intermediate_size, **kw)
        self.down_proj = nn.Linear(config.intermediate_size,
                                   config.hidden_size, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, hidden, position_offset=0):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden),
                                         position_offset)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class LlamaModel(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, **kw)
            for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            **kw)

    def forward(self, input_ids, position_offset=0):
        hidden = self.embed_tokens(input_ids)
        for layer in self.layers:
            hidden = layer(hidden, position_offset)
        return self.norm(hidden)


class LlamaForCausalLM(nn.Module):
    """Causal LM. Built on ``device`` (default ``cuda``; raises without
    CUDA unless ``device="cpu"``) in ``config.dtype``, with weights drawn
    from ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    omitted): Linear weights Xavier-normal, embeddings N(0, 1), norms 1,
    biases 0, the reference's initializers. To hold the reference's exact
    weights, carry its ``state_dict()`` with
    :func:`~paddle_tpu_torch.nlp.convert.load_paddle_tpu_arrays`."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        _check_ported(config)
        dev = resolve_device(device)
        dtype = config.torch_dtype
        self.config = config
        self.llama = LlamaModel(config, device=dev, dtype=dtype)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, device=dev, dtype=dtype)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                std = math.sqrt(2.0 / (fan_in + fan_out))
                mod.weight.normal_(0.0, std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def forward(self, input_ids, position_offset=0, caches=None,
                cu_seqlens=None):
        """Logits (B, S, vocab) of a causal forward without a KV cache."""
        if caches is not None:
            raise NotImplementedError(
                "contiguous-cache generation is not ported yet "
                "(ROADMAP A4); serve through ServingEngine")
        if cu_seqlens is not None:
            raise NotImplementedError(
                "packed cu_seqlens training is not ported yet (ROADMAP A3)")
        return self.lm_head(self.llama(input_ids, position_offset))
