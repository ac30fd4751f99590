"""GPT-2 family in PyTorch (counterpart of ``paddle_tpu/nlp/gpt.py``).

Pre-LN transformer with learned positional embeddings and an erf-GELU
MLP. Module names mirror the reference's: the blocks are the ModuleList
``gpt.h``, so the reference's ``gpt.h.{i}...`` keys land on them, and the
carry (``nlp/convert.py``) transposes each Linear weight once.

Attention is causal ``F.scaled_dot_product_attention``: the flash kernel
K4 forward, K7 backward. The reference reads q, k and v as strided views
of one (B, S, 3, H, D) projection; the kernels take contiguous inputs, so
each is made contiguous at the call. LayerNorm has no kernel (the
reference's runs through XLA). Training: the port's ``JittedTrainStep``
and optimizers; with ``fuse_linear_cross_entropy`` the model returns the
final hidden states and the caller applies
``incubate.nn.functional.fused_linear_cross_entropy`` with
``lm_head.weight``. Block recompute ("full", "selective") goes through
``distributed/fleet/utils/recompute.py``. ``generate`` is the reference's
host greedy loop of full forwards, with no KV cache.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from .._later import not_ported
from ..distributed.fleet.utils.recompute import recompute, should_remat_layer
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, LayerList, Linear
from ..nn.layer.norm import LayerNorm
from .llama import _model_dtype
from ..nn.layer.layers import Layer

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM"]


class GPTConfig:
    """Configuration; the same fields and presets as the reference's."""

    def __init__(self, vocab_size=50304, hidden_size=1024,
                 num_hidden_layers=24, num_attention_heads=16,
                 intermediate_size=None, max_position_embeddings=1024,
                 layer_norm_epsilon=1e-5, dropout=0.0,
                 tensor_parallel=False, use_recompute=False,
                 recompute_granularity="full", dtype="float32",
                 fuse_linear_cross_entropy=False, lce_chunk_rows=1024):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.layer_norm_epsilon = layer_norm_epsilon
        self.dropout = dropout
        self.tensor_parallel = tensor_parallel
        self.use_recompute = use_recompute
        self.recompute_granularity = recompute_granularity
        self.dtype = dtype
        self.fuse_linear_cross_entropy = fuse_linear_cross_entropy
        self.lce_chunk_rows = lce_chunk_rows

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self):
        return _model_dtype(self.dtype)

    @staticmethod
    def gpt2_345m(**overrides):
        cfg = dict(vocab_size=50304, hidden_size=1024, num_hidden_layers=24,
                   num_attention_heads=16, max_position_embeddings=1024)
        cfg.update(overrides)
        return GPTConfig(**cfg)

    @staticmethod
    def tiny(**overrides):
        cfg = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, max_position_embeddings=128)
        cfg.update(overrides)
        return GPTConfig(**cfg)


class GPTBlock(Layer):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, d = config.num_attention_heads, config.head_dim
        e, f = config.hidden_size, config.intermediate_size
        self.num_heads, self.head_dim = h, d
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(e, epsilon=config.layer_norm_epsilon, **kw)
        self.ln_2 = LayerNorm(e, epsilon=config.layer_norm_epsilon, **kw)
        self.qkv = Linear(e, 3 * h * d, **kw)
        self.out_proj = Linear(h * d, e, **kw)
        self.fc_in = Linear(e, f, **kw)
        self.fc_out = Linear(f, e, **kw)
        self.dropout = Dropout(config.dropout)

    def forward(self, hidden):
        b, s, _ = hidden.shape
        qkv = self.qkv(self.ln_1(hidden)).view(b, s, 3, self.num_heads,
                                               self.head_dim)
        q, k, v = (t.contiguous() for t in qkv.unbind(2))
        attn = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        attn = attn.reshape(b, s, self.num_heads * self.head_dim)
        hidden = hidden + self.dropout(self.out_proj(attn))
        x = self.ln_2(hidden)
        return hidden + self.dropout(self.fc_out(F.gelu(self.fc_in(x))))


class GPTModel(Layer):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.wte = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, **kw)
        self.h = LayerList(GPTBlock(config, **kw)
                           for _ in range(config.num_hidden_layers))
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, **kw)

    @property
    def blocks(self):
        """The reference's name for the blocks (``gpt.blocks[i]``)."""
        return self.h

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        hidden = self.wte(input_ids) + self.wpe(pos)[None]
        for i, blk in enumerate(self.h):
            if should_remat_layer(self.config, i):
                hidden = recompute(blk, hidden)
            else:
                hidden = blk(hidden)
        return self.ln_f(hidden)


class GPTForCausalLM(Layer):
    """Causal LM. Built on ``device`` (default ``cuda``; raises without
    CUDA unless ``device="cpu"``) in ``config.dtype``, with weights drawn
    from ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    omitted): Linear weights Xavier-normal, embeddings N(0, 1), LayerNorm
    weights 1, biases 0, the reference's initializers. Carry the
    reference's exact weights with
    :func:`~paddle_tpu_torch.nlp.convert.load_paddle_tpu_arrays`.
    ``tensor_parallel=True`` raises: the tensor-parallel GPT needs a
    device mesh (ROADMAP A7)."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        if config.tensor_parallel:
            not_ported("GPT tensor_parallel (a device mesh)", "A7")()
        dev = resolve_device(device)
        dtype = config.torch_dtype
        self.config = config
        self.gpt = GPTModel(config, device=dev, dtype=dtype)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
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

    def forward(self, input_ids):
        """Logits (B, S, vocab); with ``config.fuse_linear_cross_entropy``
        the final hidden states (B, S, hidden): the lm-head product then
        happens inside the fused criterion."""
        hidden = self.gpt(input_ids)
        if self.config.fuse_linear_cross_entropy:
            return hidden
        return self.lm_head(hidden)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32,
                 decode_strategy="greedy_search", eos_token_id=None,
                 **kwargs):
        """The reference's host greedy loop: each new token is the argmax
        of a full forward's last logits (no KV cache), with an optional
        eos early exit once every row emitted it. Unknown kwargs raise
        ``TypeError`` and any strategy but greedy ``NotImplementedError``,
        as in the reference. Returns (B, S + new) int64 ids on the
        model's device."""
        if kwargs:
            raise TypeError(
                f"GPT generate: unsupported kwargs {sorted(kwargs)}")
        if decode_strategy not in ("greedy_search", "greedy"):
            raise NotImplementedError(
                "GPT generate supports greedy_search only (the on-device "
                "sampling/beam loops ride the llama KV-cache decode)")
        dev = self.lm_head.weight.device
        cur = (input_ids.detach().cpu().numpy()
               if isinstance(input_ids, torch.Tensor)
               else np.asarray(input_ids)).astype(np.int64)
        for _ in range(max_new_tokens):
            # the submodules directly: under fuse_linear_cross_entropy
            # forward() returns hidden states
            hidden = self.gpt(torch.from_numpy(cur).to(dev))
            logits = self.lm_head(hidden)
            nxt = logits[:, -1:].argmax(-1).cpu().numpy()
            cur = np.concatenate([cur, nxt], axis=1)
            if eos_token_id is not None and (nxt == eos_token_id).all():
                break
        return torch.from_numpy(cur).to(dev)
