"""T5 encoder-decoder family in PyTorch (counterpart of
``paddle_tpu/nlp/t5.py``).

RMS-style T5 LayerNorm (the port's ``RMSNorm``: K1 forward, K6 backward
on CUDA tensors), relative-position-bucket attention bias (layer 0's
table shared by every layer of a stack, as the reference), a ReLU or
gated-GELU MLP and tied embeddings: the encoder and the decoder embed
through the one ``shared`` table, and the tied head multiplies by it.
Module names are the reference's, so its ``state_dict`` keys carry with
:func:`~paddle_tpu_torch.nlp.convert.load_paddle_tpu_arrays`.

T5's attention does not scale by 1/sqrt(d) and adds the bucketed bias
(and the causal mask, -1e30) in f32 before its softmax: it is plain f32
attention in both packages, never a flash kernel.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..nn import functional as F
from ..nn.functional.common import torch_linear
from ..nn.layer.common import Dropout, Embedding, LayerList, Linear
from ..nn.layer.norm import RMSNorm
from .bert import _device_and_generator, _init_weights
from ..nn.layer.layers import Layer

__all__ = ["T5Config", "T5Attention", "T5Model",
           "T5ForConditionalGeneration", "relative_position_bucket"]

# additive bias of a masked key (the reference's)
_MASKED = -1e30


class T5Config:
    """Configuration; the same fields and defaults (t5-small's widths) as
    the reference's."""

    def __init__(self, vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
                 num_layers=6, num_decoder_layers=None, num_heads=8,
                 relative_attention_num_buckets=32,
                 relative_attention_max_distance=128,
                 dropout_rate=0.1, layer_norm_epsilon=1e-6,
                 feed_forward_proj="relu", tie_word_embeddings=True,
                 pad_token_id=0, decoder_start_token_id=0):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.d_kv = d_kv
        self.d_ff = d_ff
        self.num_layers = num_layers
        self.num_decoder_layers = num_decoder_layers or num_layers
        self.num_heads = num_heads
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = relative_attention_max_distance
        self.dropout_rate = dropout_rate
        self.layer_norm_epsilon = layer_norm_epsilon
        self.feed_forward_proj = feed_forward_proj
        self.tie_word_embeddings = tie_word_embeddings
        self.pad_token_id = pad_token_id
        self.decoder_start_token_id = decoder_start_token_id

    @classmethod
    def tiny(cls, **overrides):
        cfg = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                   num_layers=2, num_heads=4, dropout_rate=0.0)
        cfg.update(overrides)
        return cls(**cfg)


def relative_position_bucket(relative_position, bidirectional, num_buckets,
                             max_distance):
    """T5's log-bucketed relative positions (int32), in the reference's
    f32 arithmetic."""
    rp = relative_position
    if bidirectional:
        num_buckets //= 2
        ret = (rp > 0).to(torch.int32) * num_buckets
        rp = rp.abs()
    else:
        ret = torch.zeros_like(rp, dtype=torch.int32)
        rp = torch.clamp_min(-rp, 0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    large = max_exact + (
        torch.log(rp.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp_max(large, num_buckets - 1)
    return ret + torch.where(is_small, rp.to(torch.int32), large)


class T5Attention(Layer):
    def __init__(self, config, has_relative_bias=False, bidirectional=True,
                 device=None):
        super().__init__()
        self.cfg = config
        inner = config.num_heads * config.d_kv
        kw = dict(bias=False, device=device)
        self.q = Linear(config.d_model, inner, **kw)
        self.k = Linear(config.d_model, inner, **kw)
        self.v = Linear(config.d_model, inner, **kw)
        self.o = Linear(inner, config.d_model, **kw)
        self.has_relative_bias = has_relative_bias
        self.bidirectional = bidirectional
        if has_relative_bias:
            self.relative_attention_bias = Embedding(
                config.relative_attention_num_buckets, config.num_heads,
                device=device)

    def compute_bias(self, q_len, k_len):
        """(1, H, Sq, Sk) additive bias from bucketed relative
        positions."""
        table = self.relative_attention_bias.weight
        ctx = torch.arange(q_len, device=table.device)[:, None]
        mem = torch.arange(k_len, device=table.device)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, self.bidirectional,
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        return table[buckets].permute(2, 0, 1)[None]

    def forward(self, hidden, key_value=None, bias=None, causal=False):
        b, sq, _ = hidden.shape
        kv_src = key_value if key_value is not None else hidden
        sk = kv_src.shape[1]
        h, d = self.cfg.num_heads, self.cfg.d_kv
        q = self.q(hidden).reshape(b, sq, h, d)
        k = self.k(kv_src).reshape(b, sk, h, d)
        v = self.v(kv_src).reshape(b, sk, h, d)
        # no 1/sqrt(d) scale (T5's)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if bias is not None:
            logits = logits + bias.float()
        if causal:
            keep = torch.ones(sq, sk, dtype=torch.bool,
                              device=logits.device).tril(sk - sq)
            logits = torch.where(keep, logits, _MASKED)
        p = torch.softmax(logits, dim=-1)
        drop = self.cfg.dropout_rate if self.training else 0.0
        if drop > 0.0:  # the reference drops attention probabilities too
            keep = torch.rand(p.shape, device=p.device) < 1.0 - drop
            p = torch.where(keep, p / (1.0 - drop), 0.0)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
        return self.o(out.reshape(b, sq, h * d))


class T5FF(Layer):
    def __init__(self, config, device=None):
        super().__init__()
        self.gated = config.feed_forward_proj.startswith("gated")
        kw = dict(bias=False, device=device)
        if self.gated:
            self.wi_0 = Linear(config.d_model, config.d_ff, **kw)
            self.wi_1 = Linear(config.d_model, config.d_ff, **kw)
        else:
            self.wi = Linear(config.d_model, config.d_ff, **kw)
        self.wo = Linear(config.d_ff, config.d_model, **kw)

    def forward(self, x):
        if self.gated:
            # the reference's gated-gelu is the tanh-approximate form
            return self.wo(
                F.gelu(self.wi_0(x), approximate=True) * self.wi_1(x))
        return self.wo(F.relu(self.wi(x)))


class T5Block(Layer):
    def __init__(self, config, is_decoder, has_relative_bias, device=None):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.is_decoder = is_decoder
        self.ln1 = RMSNorm(config.d_model, epsilon=eps, device=device)
        self.self_attn = T5Attention(config, has_relative_bias,
                                     bidirectional=not is_decoder,
                                     device=device)
        if is_decoder:
            self.ln_cross = RMSNorm(config.d_model, epsilon=eps,
                                    device=device)
            self.cross_attn = T5Attention(config, False, device=device)
        self.ln2 = RMSNorm(config.d_model, epsilon=eps, device=device)
        self.ff = T5FF(config, device=device)
        self.dropout = Dropout(config.dropout_rate)

    def forward(self, hidden, bias=None, memory=None, memory_bias=None):
        h = hidden + self.dropout(self.self_attn(
            self.ln1(hidden), bias=bias, causal=self.is_decoder))
        if self.is_decoder and memory is not None:
            h = h + self.dropout(self.cross_attn(
                self.ln_cross(h), key_value=memory, bias=memory_bias))
        return h + self.dropout(self.ff(self.ln2(h)))


class T5Stack(Layer):
    def __init__(self, config, is_decoder, embed, device=None):
        super().__init__()
        self.cfg = config
        self.is_decoder = is_decoder
        self.embed_tokens = embed
        n = config.num_decoder_layers if is_decoder else config.num_layers
        self.blocks = LayerList([
            T5Block(config, is_decoder, has_relative_bias=(i == 0),
                    device=device) for i in range(n)])
        self.final_layer_norm = RMSNorm(
            config.d_model, epsilon=config.layer_norm_epsilon, device=device)
        self.dropout = Dropout(config.dropout_rate)

    def forward(self, input_ids, memory=None, attention_mask=None,
                memory_mask=None):
        hidden = self.dropout(self.embed_tokens(input_ids))
        s = hidden.shape[1]
        # layer 0's bias table serves every layer (the reference's)
        bias = self.blocks[0].self_attn.compute_bias(s, s)
        if attention_mask is not None:
            bias = bias + attention_mask
        out = hidden
        for block in self.blocks:
            out = block(out, bias=bias, memory=memory,
                        memory_bias=memory_mask)
        return self.dropout(self.final_layer_norm(out))


def _pad_bias(input_ids, pad_id):
    """(B, S) ids -> additive (B, 1, 1, S) f32 bias masking pad keys."""
    return torch.where((input_ids != pad_id)[:, None, None, :], 0.0,
                       _MASKED).float()


class T5Model(Layer):
    """Encoder and decoder over one ``shared`` embedding. Built on
    ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``) in f32, with weights drawn from ``generator`` (a
    ``torch.Generator`` on that device; seed 0 when omitted): Linear
    weights Xavier-normal, embeddings N(0, 1), norms 1. Returns
    ``(decoder hidden, encoder memory)``."""

    def __init__(self, config=None, device=None, generator=None, **kw):
        super().__init__()
        dev, generator = _device_and_generator(device, generator)
        cfg = config or T5Config(**kw)
        self.config = cfg
        self.shared = Embedding(cfg.vocab_size, cfg.d_model, device=dev)
        self.encoder = T5Stack(cfg, False, self.shared, device=dev)
        self.decoder = T5Stack(cfg, True, self.shared, device=dev)
        _init_weights([self], generator)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None):
        enc_bias = (_pad_bias(input_ids, self.config.pad_token_id)
                    if attention_mask is None else attention_mask)
        memory = self.encoder(input_ids, attention_mask=enc_bias)
        dec = self.decoder(decoder_input_ids, memory=memory,
                           memory_mask=enc_bias)
        return dec, memory


class T5ForConditionalGeneration(Layer):
    """``T5Model`` and a language-model head: tied to ``shared`` (hidden
    scaled by d_model^-0.5 first, the reference's) unless
    ``tie_word_embeddings`` is False. With ``labels`` returns ``(mean
    cross entropy over labels != -100, logits)``. Device and weights as
    :class:`T5Model`."""

    def __init__(self, config=None, device=None, generator=None, **kw):
        super().__init__()
        dev, generator = _device_and_generator(device, generator)
        cfg = config or T5Config(**kw)
        self.config = cfg
        self.t5 = T5Model(cfg, device=dev, generator=generator)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size, bias=False,
                                  device=dev)
            _init_weights([self.lm_head], generator)

    def forward(self, input_ids, decoder_input_ids, labels=None,
                attention_mask=None):
        hidden, _ = self.t5(input_ids, decoder_input_ids,
                            attention_mask=attention_mask)
        if self.config.tie_word_embeddings:
            hidden = hidden * (self.config.d_model ** -0.5)
            logits = torch_linear(hidden, self.t5.shared.weight)
        else:
            logits = self.lm_head(hidden)
        if labels is not None:
            ce = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                                 labels.reshape(-1), ignore_index=-100)
            return ce, logits
        return logits

    def prepare_decoder_input_ids(self, labels):
        """Labels shifted right behind ``decoder_start_token_id``, with
        -100 replaced by ``pad_token_id`` (the reference's helper)."""
        start = torch.full((labels.shape[0], 1),
                           self.config.decoder_start_token_id,
                           dtype=labels.dtype, device=labels.device)
        shifted = torch.cat([start, labels[:, :-1]], dim=1)
        return torch.where(shifted == -100,
                           torch.full_like(shifted,
                                           self.config.pad_token_id),
                           shifted)
