"""Transformer layers (counterpart of
``paddle_tpu/nn/layer/transformer.py``).

``MultiHeadAttention``, the encoder and decoder layers and stacks, and
``Transformer``, with the reference's sublayer names (``q_proj``,
``k_proj``, ``v_proj``, ``out_proj``, ``linear1``, ``linear2``,
``norm1`` ...), so ``nlp.convert`` carries the reference's weights.
Attention goes through the port's
:func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention` in
the (B, S, H, D) layout, whose rule is the reference's: no mask and no
dropout at D in {64, 128} takes the flash kernel (K4 forward, K7
backward on CUDA tensors); a mask, dropout or a narrower head takes the
plain f32 attention on every device. A decoder's causal self-attention
carries its mask from :meth:`Transformer.generate_square_subsequent_mask`
and so takes the plain path, as in the reference; cross-attention without
``memory_mask`` and the encoder without ``src_mask`` reach the kernels.

Incremental decoding: ``gen_cache`` gives a ``Cache`` of empty (B, 0, H,
D) keys and values (each call appends the step's keys, so a one-token
query attends to every key so far: K4 at Sq = 1) or a ``StaticCache`` of
projected memory keys and values (cross-attention).

As the port's other layers, these take ``device`` / ``dtype`` as
``torch.nn`` does (``None`` is torch's default device); the models built
on them (``nlp.bert``, ``nlp.t5``) resolve theirs. Weights start as
``torch.nn.Linear``'s: carry the reference's to compare.
"""
from __future__ import annotations

import collections
import copy

import torch

from .. import functional as F
from .common import Dropout, LayerList, Linear
from .norm import LayerNorm
from .layers import Layer

__all__ = [
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
]


def _bias(bias_attr):
    return bias_attr is not False


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(bias=_bias(bias_attr), device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        # (B, S, E) -> (B, S, H, D)
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """``StaticCache`` of the projected ``key`` / ``value`` (cross
        attention), else an empty incremental ``Cache`` on key's device."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return MultiHeadAttention.StaticCache(k, v)
        empty = key.new_zeros((key.shape[0], 0, self.num_heads,
                               self.head_dim))
        return MultiHeadAttention.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = MultiHeadAttention.Cache(k, v)
        if attn_mask is not None and attn_mask.dim() == 3:
            attn_mask = attn_mask.unsqueeze(0)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(
                cache, MultiHeadAttention.StaticCache):
            return out, cache
        if self.need_weights:
            return out, None
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward,
                              bias=_bias(bias_attr), **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model,
                              bias=_bias(bias_attr), **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself, the rest deep copies), then ``norm`` when given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward,
                              bias=_bias(bias_attr), **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model,
                              bias=_bias(bias_attr), **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (incr_cache, cache[1])

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 dtype=None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        kw = dict(device=device, dtype=dtype)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            enc_norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            dec_norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """(length, length) f32 additive mask: 0 on and below the
        diagonal, -inf above (on ``device``, torch's default when
        None)."""
        return torch.full((length, length), -torch.inf, device=device,
                          dtype=torch.float32).triu(1)
