"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

Layout (batch, seq, heads, head_dim), paddle's flash-attn layout. Without
a mask or dropout, attention goes through
:class:`~paddle_tpu_torch.ops.flash_attention.FlashAttentionFunction` (K4
forward, K7 backward on CUDA tensors; their plain versions on CPU
tensors), as the reference routes to its Pallas flash kernel. An
``attn_mask``, dropout or a head width under 64 takes the plain
:func:`_xla_attention` on every device, as the reference sends them to
XLA (its gate, ``paddle_tpu/nn/functional/attention.py:71-75`` and
``:107-113``, is a shape rule: D < 64 never reaches its kernel). Widths
of 64 and above reach the kernel, which takes D in {64, 128} and refuses
the rest (ROADMAP A10). Packed (cu_seqlens) attention,
:func:`flash_attn_unpadded`, goes through ``VarlenFlashAttentionFunction``
(``ops/varlen_flash_attention.py``: K3 forward, K8 backward; K8a/K8b in
f32). Under ``amp.auto_cast`` the dense functionals cast their inputs by
amp's rules (``scaled_dot_product_attention``, which ``flash_attention``
calls, is white-listed: O1 attends in the amp dtype, fp16 included).
"""
from __future__ import annotations

import math

import torch

from ... import amp
from ...amp import amp_state
from ...ops.flash_attention import FlashAttentionFunction, band_mask
from ...ops.varlen_flash_attention import VarlenFlashAttentionFunction

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sliding_window_attention"]

# the reference's gate: narrower heads take the XLA path on every backend
_KERNEL_MIN_HEAD_DIM = 64


def _xla_attention(q, k, v, mask=None, causal=False, dropout_p=0.0,
                   scale=None, generator=None):
    """Plain masked attention in f32 (the reference's XLA path); layout
    (B, S, H, D). ``mask``: bool (True = keep) or an additive bias,
    broadcastable to (B, H, Sq, Sk). Dropout draws its keep mask from
    ``generator``."""
    if k.shape[2] != q.shape[2]:  # GQA/MQA: repeat kv heads to q heads
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sc
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        logits = logits.masked_fill(~band_mask(sq, sk, True,
                                               device=q.device), -math.inf)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -math.inf)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def sliding_window_attention(query, key, value, window_size, training=True,
                             name=None):
    """Causal sliding-window attention (Mistral semantics: each query
    attends to the last ``window_size`` keys, itself included) through
    K4's banded tiles (K7 backward); heads narrower than 64 through the
    plain band-masked :func:`_xla_attention`, as the reference."""
    w = int(window_size)
    if w < 1:
        raise ValueError(f"window_size must be >= 1, got {window_size}")
    if amp_state.enabled:
        query, key, value = amp.cast_inputs_for_op(
            "sliding_window_attention", query, key, value)
    if query.shape[-1] < _KERNEL_MIN_HEAD_DIM:
        band = band_mask(query.shape[1], key.shape[1], True, w,
                         device=query.device)
        return _xla_attention(query, key, value, mask=band)
    return FlashAttentionFunction.apply(query, key, value, True, None, w)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """Paddle's SDPA. ``generator`` (a ``torch.Generator`` on the inputs'
    device) feeds the dropout keep mask when ``dropout_p > 0`` and
    ``training``."""
    dropout = dropout_p if training else 0.0
    if amp_state.enabled:
        query, key, value, attn_mask = amp.cast_inputs_for_op(
            "scaled_dot_product_attention", query, key, value, attn_mask)
    if attn_mask is None and dropout == 0.0 \
            and query.shape[-1] >= _KERNEL_MIN_HEAD_DIM:
        return FlashAttentionFunction.apply(query, key, value, is_causal)
    return _xla_attention(query, key, value, mask=attn_mask,
                          causal=is_causal, dropout_p=dropout,
                          generator=generator)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, generator=None):
    """``paddle.nn.functional.flash_attention.flash_attention``: returns
    ``(out, None)`` (no softmax is materialized)."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training, generator=generator)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        window_size=None, name=None):
    """Varlen flash attention over packed ``(total_tokens, H, D)`` inputs
    with ``cu_seqlens`` prefix sums (int32, on the inputs' device); returns
    ``(out, None)``. Runs :class:`VarlenFlashAttentionFunction`: the
    kernels K3 / K8 (K8a / K8b in f32) on CUDA tensors, their plain
    versions on CPU tensors. ``window_size`` (causal only) applies the
    sliding-window band per segment. Dropout in training is not ported:
    the reference sends it to XLA's masked attention, outside the
    kernel."""
    if window_size is not None:
        if not causal:
            raise ValueError(
                "flash_attn_unpadded: window_size requires causal=True")
        if window_size < 1:
            raise ValueError(
                f"flash_attn_unpadded: window_size must be >= 1, got "
                f"{window_size}")
    if dropout > 0.0 and training:
        raise NotImplementedError(
            "flash_attn_unpadded with dropout in training is not ported "
            "(the reference leaves the varlen kernel for XLA there)")
    out = VarlenFlashAttentionFunction.apply(
        query, key, value, cu_seqlens_q, cu_seqlens_k, causal, scale,
        window_size)
    return out, None
