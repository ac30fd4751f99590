"""FusedMultiTransformer: the whole pre-LN decoder stack as one module
(counterpart of ``paddle_tpu/incubate/nn/fused_transformer.py``).

Per layer: norm, qkv, rotary, attention over the KV cache, out-proj,
norm, FFN. The weights are held stacked with a leading ``num_layers``
dim, in the reference's ``(L, in, out)`` layout (the carry copies them as
they are); the layer loop walks per-layer views of the stacks, where the
reference scans them. Prefill (no cache, or a cache at any offset with
more than one token) is causal ``F.scaled_dot_product_attention`` over
``cache[:, :offset + s]``: the flash kernel K4, bottom-right aligned, so
a chunked prefill's queries see the whole cached prefix. A one-token
call at ``offset > 0`` with caches is decode: the kernel K5 on the
layer's cache and the row lengths (``seq_lens``, default ``offset + 1``);
on the CPU K5's plain version, which computes the reference's
``_masked_decode_attn`` wherever a row has a live key. The rmsnorm arm is
``F.rms_norm`` (K1: the same function in f32 with one rounding), the
layernorm arm the reference's formula. The FFN's GELU is the tanh form
(``jax.nn.gelu``'s default, which the reference calls); swiglu is
``silu(gate) * up``.

Weight-only int8 (:meth:`FusedMultiTransformer.quantize_weight_only`)
keeps the four matmul stacks int8 with (L, out) f32 scales, and each
product is ``(x @ w.to(x.dtype)) * scale.to(x.dtype)``: the cast per call,
then the scale after the product, the reference's rounding order.

The tensor-parallel stack (``nranks > 1``, a ring) needs a device mesh
and raises (ROADMAP A7). Caches are written in place and the same pair is
returned (the reference returns new arrays).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..._device import resolve_device
from ..._later import not_ported
from ...nn import functional as F
from ...nn.functional.rope import apply_rotary_emb, build_rope_cache
from ...nn.quant import weight_quantize_stacked
from ...ops.decode_attention import decode_attention
from ...core.dtype import one_of
from ...nn.layer.layers import Layer

__all__ = ["FusedMultiTransformer"]

_MATMULS = ("qkv_weight", "linear_weight", "ffn1_weight", "ffn2_weight")
_DTYPES = (torch.float32, torch.bfloat16)


def _dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    dt = one_of(dtype, _DTYPES)
    if dt is None:
        raise KeyError(str(dtype))
    return dt


class FusedMultiTransformer(Layer):
    """Pre-LN decoder stack with KV-cache decode.

    Args mirror the reference's; ``norm_type`` "layernorm" | "rmsnorm",
    ``activation`` "gelu" | "swiglu", ``num_key_value_heads`` for GQA.
    Built on ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``) in ``dtype`` (default f32), with weights drawn from
    ``generator`` (seed 0 when omitted): the four matmul stacks
    Xavier-normal per layer, the norm scales 1 and the biases 0 (the
    reference draws its norm scales Xavier-normal too; carry its weights
    with ``nlp.convert.load_paddle_tpu_arrays``)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu",
                 normalize_before=True, num_layers=1,
                 nranks=1, trans_qkvw=True, ring_id=-1,
                 norm_type="layernorm", use_neox_rotary_style=True,
                 num_key_value_heads=None, epsilon=1e-5,
                 rope_theta=10000.0, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN")
        if nranks > 1 or ring_id != -1:
            not_ported("FusedMultiTransformer tensor parallelism "
                       "(nranks / ring_id over a device mesh)", "A7")()
        if norm_type not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm_type must be layernorm|rmsnorm, got "
                             f"{norm_type!r}")
        if activation not in ("gelu", "swiglu"):
            raise ValueError(f"activation must be gelu|swiglu, got "
                             f"{activation!r}")
        dev = resolve_device(device)
        dt = _dtype(dtype) or torch.float32
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_key_value_heads or num_heads
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self.num_layers = num_layers
        self.activation = activation
        self.norm_type = norm_type
        self.use_neox = use_neox_rotary_style
        self.epsilon = epsilon
        self.rope_theta = rope_theta
        L, E, H, HK, D, FFN = (num_layers, embed_dim, num_heads,
                               self.num_kv_heads, self.head_dim,
                               dim_feedforward)
        qkv_out = (H + 2 * HK) * D
        ffn1_out = 2 * FFN if activation == "swiglu" else FFN
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def mk(shape, fill=None):
            t = torch.empty(shape, device=dev, dtype=dt)
            if fill is not None:
                t.fill_(fill)
            else:
                std = math.sqrt(2.0 / (shape[-2] + shape[-1]))
                t.normal_(0.0, std, generator=generator)
            return nn.Parameter(t)

        layernorm = norm_type == "layernorm"
        # registration order is the reference's state_dict order
        self.ln_scale = mk((L, E), 1.0)
        self.ln_bias = mk((L, E), 0.0) if layernorm else None
        self.qkv_weight = mk((L, E, qkv_out))
        self.qkv_bias = mk((L, qkv_out), 0.0)
        self.linear_weight = mk((L, H * D, E))
        self.linear_bias = mk((L, E), 0.0)
        self.ffn_ln_scale = mk((L, E), 1.0)
        self.ffn_ln_bias = mk((L, E), 0.0) if layernorm else None
        self.ffn1_weight = mk((L, E, ffn1_out))
        self.ffn1_bias = mk((L, ffn1_out), 0.0)
        self.ffn2_weight = mk((L, FFN, E))
        self.ffn2_bias = mk((L, E), 0.0)
        self._wo_int8 = False
        for name in _MATMULS:
            setattr(self, name + "_scale", None)

    @torch.no_grad()
    def quantize_weight_only(self):
        """Turn the four matmul stacks into int8 with per-layer,
        per-out-channel f32 scales (``weight_quantize_stacked`` over the
        ``in`` axis, the reference's algorithm), kept as parameters
        without gradient. Idempotent; returns self."""
        if self._wo_int8:
            return self
        for name in _MATMULS:
            q, scale = weight_quantize_stacked(getattr(self, name).data,
                                               axis=1)
            setattr(self, name, nn.Parameter(q, requires_grad=False))
            setattr(self, name + "_scale",
                    nn.Parameter(scale, requires_grad=False))
        self._wo_int8 = True
        return self

    def gen_cache(self, batch_size, max_length, dtype="float32"):
        """Stacked KV caches: a pair of zero (L, B, S_max, HK, D) tensors
        on the module's device."""
        shape = (self.num_layers, batch_size, max_length, self.num_kv_heads,
                 self.head_dim)
        dev = self.qkv_bias.device
        dt = _dtype(dtype)
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None, name=None):
        """src: (B, S, E). With ``caches`` (from :meth:`gen_cache`) and
        ``time_step`` (the int position offset) this call's K/V are
        written at ``time_step`` and a one-token call at ``time_step > 0``
        decodes; otherwise a causal prefill. ``seq_lens`` (B,) are the
        decode rows' live cache lengths. Returns ``out`` or ``(out,
        caches)``. ``attn_mask``, ``pre_caches``, ``rotary_embs`` and
        ``rotary_emb_dims`` are taken for the reference's signature and,
        as there, not read."""
        offset = int(time_step) if time_step is not None else 0
        kc, vc = caches if caches is not None else (None, None)
        b, s, _ = src.shape
        decode = kc is not None and s == 1 and offset > 0
        lens = None
        if decode:
            lens = (seq_lens.to(src.device, torch.int32) if seq_lens is not None
                    else torch.full((b,), offset + s, dtype=torch.int32,
                                    device=src.device))
        cos, sin = build_rope_cache(s, self.head_dim, base=self.rope_theta,
                                    position_offset=offset,
                                    device=src.device)
        hidden = src
        for i in range(self.num_layers):
            hidden = self._layer(i, hidden, cos, sin,
                                 None if kc is None else kc[i],
                                 None if vc is None else vc[i],
                                 offset, decode, lens)
        if caches is not None:
            return hidden, (kc, vc)
        return hidden

    def _norm(self, x, scale, bias):
        if self.norm_type == "rmsnorm":
            return F.rms_norm(x, scale.to(x.dtype), epsilon=self.epsilon)
        xf = x.float()
        out = torch.nn.functional.layer_norm(xf, (xf.shape[-1],),
                                             eps=self.epsilon)
        return (out * scale + bias).to(x.dtype)

    def _mm(self, x, name, i):
        """``x @ w[i]``; int8 stacks cast to x's dtype, the per-channel
        scale applied after the product."""
        y = x @ getattr(self, name)[i].to(x.dtype)
        scale = getattr(self, name + "_scale")
        return y if scale is None else y * scale[i].to(x.dtype)

    def _layer(self, i, hidden, cos, sin, kci, vci, offset, decode, lens):
        b, s, _ = hidden.shape
        H, HK, D = self.num_heads, self.num_kv_heads, self.head_dim
        x = self._norm(hidden, self.ln_scale[i],
                       None if self.ln_bias is None else self.ln_bias[i])
        qkv = self._mm(x, "qkv_weight", i) + self.qkv_bias[i].to(x.dtype)
        q = qkv[..., : H * D].reshape(b, s, H, D)
        k = qkv[..., H * D: (H + HK) * D].reshape(b, s, HK, D)
        v = qkv[..., (H + HK) * D:].reshape(b, s, HK, D)
        q = apply_rotary_emb(q, cos, sin, neox=self.use_neox)
        k = apply_rotary_emb(k, cos, sin, neox=self.use_neox)
        if kci is not None:
            # the reference's dynamic_update_slice clamps the start so the
            # update fits
            start = min(max(offset, 0), kci.shape[1] - s)
            kci[:, start:start + s] = k.to(kci.dtype)
            vci[:, start:start + s] = v.to(vci.dtype)
        if decode:
            attn = decode_attention(q, kci, vci, lens)
        else:
            if kci is not None:
                k = kci[:, : offset + s].to(q.dtype)
                v = vci[:, : offset + s].to(q.dtype)
            attn = F.scaled_dot_product_attention(
                q, k.contiguous(), v.contiguous(), is_causal=True)
        attn = attn.reshape(b, s, H * D)
        hidden = hidden + (self._mm(attn, "linear_weight", i)
                           + self.linear_bias[i].to(attn.dtype))
        x = self._norm(hidden, self.ffn_ln_scale[i],
                       None if self.ffn_ln_bias is None
                       else self.ffn_ln_bias[i])
        h1 = self._mm(x, "ffn1_weight", i) + self.ffn1_bias[i].to(x.dtype)
        if self.activation == "swiglu":
            gate, up = h1.chunk(2, dim=-1)
            h1 = F.silu(gate.float()).to(up.dtype) * up
        else:
            h1 = F.gelu(h1.float(), approximate=True).to(h1.dtype)
        return hidden + (self._mm(h1, "ffn2_weight", i)
                         + self.ffn2_bias[i].to(h1.dtype))
