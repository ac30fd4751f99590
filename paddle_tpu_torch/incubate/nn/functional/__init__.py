"""Fused-op wrappers, serving attention ops and the fused training loss
(counterpart of ``paddle_tpu/incubate/nn/functional/__init__.py``): the
one-token decode op ``masked_multihead_attention`` over a contiguous
cache, ``block_multihead_attention`` over the paged KV pool (float pools,
and int8 pools with static or per-row scales),
``fused_linear_cross_entropy``, and the wrappers the reference composes
from its functionals: ``fused_rms_norm`` (K1 through ``F.rms_norm``),
``fused_multi_head_attention`` (K4 through ``F.scaled_dot_product_attention``),
``fused_layer_norm``, ``fused_linear``, ``fused_bias_act``,
``fused_feedforward`` and ``fused_rotary_position_embedding`` (from
``nn/functional/rope.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ....nn import functional as _F
from ....nn.functional.rope import (apply_rotary_emb,
                                    fused_rotary_position_embedding)
from ....nn.quant import quantize_kv_rows
from ....ops.decode_attention import decode_attention, decode_attention_plain
from ....ops.paged_attention import paged_decode_attention
from ....ops.varlen_flash_attention import varlen_flash_attention
from ....tensor._helpers import ensure_tensor  # noqa: F401  (re-exported)
from .fused_linear_cross_entropy import fused_linear_cross_entropy

__all__ = ["fused_rotary_position_embedding", "fused_rms_norm",
           "fused_layer_norm", "fused_linear", "fused_bias_act",
           "fused_multi_head_attention", "fused_feedforward",
           "masked_multihead_attention", "block_multihead_attention",
           "fused_linear_cross_entropy"]


def _add_residual(x, bias, residual):
    if bias is not None:
        x = x + bias
    return x, (x + residual if residual is not None else None)


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **quant_kwargs):
    """``rms_norm(x + bias + residual)`` (K1 with a weight and no
    ``norm_bias``); with a residual returns ``(out, x + bias +
    residual)``. The quantization arguments are taken for the reference's
    signature and, as there, not read."""
    x, res = _add_residual(x, bias, residual)
    out = _F.rms_norm(res if res is not None else x, norm_weight, norm_bias,
                      epsilon, begin_norm_axis)
    return (out, res) if residual is not None else out


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None, **kw):
    """``layer_norm(x + bias + residual)`` over dims
    ``[begin_norm_axis:]``; with a residual returns ``(out, x + bias +
    residual)``."""
    x, res = _add_residual(x, bias, residual)
    x = res if res is not None else x
    out = _F.layer_norm(x, x.shape[begin_norm_axis:], norm_weight,
                        norm_bias, epsilon)
    return (out, res) if residual is not None else out


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``x @ weight + bias`` with paddle's (in, out) weight, or (out, in)
    with ``transpose_weight``."""
    if transpose_weight:
        weight = weight.t()
    return _F.linear(x, weight, bias)


def fused_bias_act(x, bias=None, act_method="gelu", **kw):
    """``act(x + bias)``, ``act_method`` naming a functional of
    ``paddle_tpu_torch.nn.functional`` (``gelu`` is the erf form)."""
    if bias is not None:
        x = x + bias
    return getattr(_F, act_method)(x)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, name=None):
    """The training-time fused attention block: (pre-)LayerNorm, the qkv
    product with paddle's (3, H, D, E) weight, non-causal attention
    (K4 through ``F.scaled_dot_product_attention`` without a mask or
    dropout; the plain masked attention with them), the out-projection
    ((H * D, E) weight), dropout, the residual and the post-LayerNorm.
    ``cache_kv`` is taken for the reference's signature and, as there,
    not read."""
    b, s, e = x.shape
    residual = x
    if pre_layer_norm:
        x = _F.layer_norm(x, [e], pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    three, h, d, _ = qkv_weight.shape
    qkv = _F.linear(x, qkv_weight.reshape(3 * h * d, e).t(),
                    None if qkv_bias is None
                    else qkv_bias.reshape(3 * h * d))
    q, k, v = (t.contiguous()
               for t in qkv.reshape(b, s, 3, h, d).unbind(2))
    attn = _F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=attn_dropout_rate,
        training=training)
    out = _F.linear(attn.reshape(b, s, h * d), linear_weight, linear_bias)
    if dropout_rate:
        out = _F.dropout(out, p=dropout_rate, training=training)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = _F.layer_norm(out, [e], ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1,
                      add_residual=True, name=None):
    """The fused FFN block: (pre-)LayerNorm, ``linear2(dropout(act(
    linear1(x))))`` with (in, out) weights, dropout, the residual and the
    post-LayerNorm."""
    e = x.shape[-1]
    residual = x
    if pre_layer_norm:
        x = _F.layer_norm(x, [e], ln1_scale, ln1_bias, ln1_epsilon)
    h = getattr(_F, activation)(_F.linear(x, linear1_weight, linear1_bias))
    if dropout1_rate:
        h = _F.dropout(h, p=dropout1_rate, training=training)
    out = _F.linear(h, linear2_weight, linear2_bias)
    if dropout2_rate:
        out = _F.dropout(out, p=dropout2_rate, training=training)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = _F.layer_norm(out, [e], ln2_scale, ln2_bias, ln2_epsilon)
    return out

def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def masked_multihead_attention(x, cache_kv=None, src_mask=None,
                               sequence_lengths=None, out_scale=-1,
                               num_heads=None, name=None):
    """One-token decode attention over a KV cache (the fused decode op
    behind ``fused_multi_transformer``).

    x: (B, H, D) or (B, 1, H, D) new-token queries; cache_kv:
    (2, B, S_max, HK, D) stacked k/v caches; sequence_lengths: (B,) valid
    entries, the new token included. Without ``src_mask`` it runs the K5
    wrapper (the kernel on CUDA tensors); an additive ``src_mask``
    (broadcastable to (B, H, 1, S_max)) takes the plain version as a
    logits bias, as the reference sends it to XLA. ``out_scale > 0``
    quantizes the output to int8, ``clip(round(out / out_scale), -128,
    127)`` (round half to even)."""
    if cache_kv is None or sequence_lengths is None:
        raise ValueError(
            "masked_multihead_attention requires cache_kv and "
            "sequence_lengths")
    kc, vc = cache_kv[0], cache_kv[1]
    lens = sequence_lengths.to(x.device, torch.int32)
    if src_mask is None:
        out = decode_attention(x, kc, vc, lens)
    else:
        out = decode_attention_plain(x, kc, vc, lens, bias=src_mask)
    if out_scale and out_scale > 0:
        out = torch.clamp(torch.round(out.float() / float(out_scale)),
                          -128, 127).to(torch.int8)
    return out


def _f32_vec(t, n, dev):
    """An optional scale argument as a flat f32 tensor of ``n`` entries."""
    if t is None:
        return None
    return torch.as_tensor(t).to(dev, torch.float32).reshape(n)


def _quant_static(x, qs):
    """int8 ``clip(round(x * qs))`` with (HK,) quant multipliers."""
    return torch.clamp(torch.round(x.float() * qs[None, :, None]),
                       -128, 127).to(torch.int8)


def block_multihead_attention(qkv, key_cache, value_cache,
                              seq_lens_encoder, seq_lens_decoder,
                              seq_lens_this_time, padding_offsets=None,
                              cum_offsets=None, cu_seqlens_q=None,
                              cu_seqlens_k=None, block_tables=None,
                              max_seq_len=None, block_size=None,
                              use_neox_rotary_style=False, num_heads=None,
                              kv_num_heads=None, head_dim=None,
                              rotary_embs=None, qkv_bias=None,
                              qkv_out_scale=None, cache_k_quant_scales=None,
                              cache_v_quant_scales=None,
                              cache_k_dequant_scales=None,
                              cache_v_dequant_scales=None,
                              cache_k_scale_pool=None,
                              cache_v_scale_pool=None, out_shift=None,
                              out_smooth=None, out_scale=-1):
    """Paged KV-cache attention for a mixed batch of prefill and decode
    rows.

    Prefill rows (including chunked prefill continuing a cached context)
    run the varlen kernel (K3) over cache + new tokens, bottom-right
    causal per row; decode rows run the paged decode kernel (K2). The new
    tokens' K/V are written into ``key_cache``/``value_cache`` IN PLACE
    with ``index_put_`` (the reference replaces the arrays its Tensors
    hold). Rows are routed on the host from the (host) length arrays; the
    index tensors are built once per call and moved to the device with
    ``non_blocking=True``.

    Args:
        qkv: (total_tokens, (H + 2*HK) * D) packed projections.
        key_cache/value_cache: (num_blocks, block_size, HK, D) pools,
            float or int8.
        seq_lens_encoder: (B,) prefill token counts (0 for decode rows).
        seq_lens_decoder: (B,) tokens already in cache.
        seq_lens_this_time: (B,) tokens entering this call per sequence.
        block_tables: (B, max_blocks) int32 pool block ids.
        rotary_embs: optional (2, max_seq_len, D/2) cos/sin table, applied
            to this call's q/k at their absolute positions.
        qkv_bias: optional ((H + 2*HK) * D,) bias added before the rope.
        qkv_out_scale: optional ((H + 2*HK) * D,) dequant multiplier of
            the incoming qkv (an int projection's output), applied in f32
            before the bias.
        cache_k_quant_scales / cache_v_quant_scales: (HK,) static quant
            multipliers of int8 pools: a new row is stored as
            ``clip(round(k * qs), -128, 127)``. ``cache_k/v_dequant_scales``
            default to ``1 / qs``; decode rows dequantize by them inside
            K2's int8 arm, prefill rows' gathered contexts before K3.
        cache_k_scale_pool / cache_v_scale_pool: (num_blocks, block_size,
            HK) f32 per-row scale pools of int8 pools (the serving
            engine's): each new row quantizes by its own abs-max
            (:func:`~paddle_tpu_torch.nn.quant.quantize_kv_rows`), its
            scale is written beside it IN PLACE, and every row of the
            batch runs as a prefill row over its dequantized context (a
            decode row as a 1-token prefill row), as in the reference.
        out_shift / out_smooth: optional (H * D,) epilogue
            ``(out + shift) * smooth``.
        out_scale: > 0 quantizes the output to int8,
            ``clip(round(out / out_scale), -128, 127)``.
        ``padding_offsets``, ``cum_offsets``, ``cu_seqlens_q/k``,
        ``max_seq_len`` and ``block_size`` are accepted for signature
        parity and derived from the lengths, as in the reference.
    Returns the attention output (total_tokens, H * D).
    """
    quant_cache = (cache_k_quant_scales is not None
                   or cache_v_quant_scales is not None)
    if quant_cache and (cache_k_quant_scales is None
                        or cache_v_quant_scales is None):
        raise ValueError(
            "int8 KV cache needs BOTH cache_k_quant_scales and "
            "cache_v_quant_scales")
    dyn_quant = (cache_k_scale_pool is not None
                 or cache_v_scale_pool is not None)
    if dyn_quant and (cache_k_scale_pool is None
                      or cache_v_scale_pool is None):
        raise ValueError(
            "dynamic int8 KV cache needs BOTH cache_k_scale_pool and "
            "cache_v_scale_pool")
    if dyn_quant and quant_cache:
        raise ValueError(
            "pass either static cache_k/v_quant_scales or per-row "
            "cache_k/v_scale_pool, not both")
    kc_dt = str(key_cache.dtype).removeprefix("torch.")
    vc_dt = str(value_cache.dtype).removeprefix("torch.")
    if kc_dt != vc_dt:
        raise ValueError(
            f"key_cache ({kc_dt}) and value_cache ({vc_dt}) dtypes "
            f"must match")
    if (quant_cache or dyn_quant) and kc_dt != "int8":
        raise ValueError(
            f"cache quant scales given but the cache pools are "
            f"{kc_dt}, not int8")
    if not quant_cache and not dyn_quant and kc_dt == "int8":
        raise ValueError(
            "int8 cache pools need cache_k/v_quant_scales or "
            "cache_k/v_scale_pool")
    if num_heads is None or kv_num_heads is None:
        raise ValueError(
            "block_multihead_attention requires num_heads/kv_num_heads "
            "(the packed qkv layout is ambiguous without them)")
    h, hk = int(num_heads), int(kv_num_heads)
    bs = int(key_cache.shape[1])
    d = int(head_dim) if head_dim is not None else qkv.shape[-1] // (h + 2 * hk)
    dev = key_cache.device

    this_time = _host(seq_lens_this_time).astype(np.int64)
    dec_lens = _host(seq_lens_decoder).astype(np.int64)
    enc_lens = _host(seq_lens_encoder).astype(np.int64)
    tbl_np = _host(block_tables).astype(np.int32)
    total = int(this_time.sum())
    b = len(this_time)

    # host-side row routing: decode rows bring one token; prefill rows
    # (fresh or chunked) bring this_time tokens and attend cache + new
    active = this_time > 0
    is_prefill_row = ((this_time > 1) | (enc_lens > 0)) & active
    if dyn_quant:
        # per-row scale pools: decode rows run as 1-token prefill rows
        # over their dequantized context, as the reference routes them
        is_prefill_row = active
    cu_all = np.concatenate([[0], np.cumsum(this_time)]).astype(np.int64)
    seq_of_tok = np.repeat(np.arange(b), this_time)
    abs_pos = dec_lens[seq_of_tok] + np.arange(total) - cu_all[seq_of_tok]
    blk_ids = tbl_np[seq_of_tok, abs_pos // bs].astype(np.int64)
    offs = abs_pos % bs

    pre_rows = np.nonzero(is_prefill_row)[0]
    dec_rows = np.nonzero(~is_prefill_row & active)[0]
    pre_tok = (np.concatenate([np.arange(cu_all[i], cu_all[i + 1])
                               for i in pre_rows])
               if len(pre_rows) else np.zeros(0, np.int64))
    dec_tok = cu_all[dec_rows]
    ctx_lens = dec_lens[pre_rows] + this_time[pre_rows]
    cu_q_pre = np.concatenate([[0], np.cumsum(this_time[pre_rows])])
    cu_k_pre = np.concatenate([[0], np.cumsum(ctx_lens)])
    ctx_seq = np.repeat(pre_rows, ctx_lens)
    ctx_pos = (np.arange(int(ctx_lens.sum()))
               - np.repeat(cu_k_pre[:-1], ctx_lens))
    ctx_blk = tbl_np[ctx_seq, ctx_pos // bs].astype(np.int64)
    ctx_off = ctx_pos % bs

    if rotary_embs is not None:
        table_len = int(rotary_embs.shape[1])
        if total and int(abs_pos.max()) >= table_len:
            raise ValueError(
                f"block_multihead_attention: token position "
                f"{int(abs_pos.max())} exceeds rotary_embs table length "
                f"{table_len}")

    def dev_tensor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            dev, non_blocking=True)

    qkv_scale_v = _f32_vec(qkv_out_scale, (h + 2 * hk) * d, dev)
    k_qs = _f32_vec(cache_k_quant_scales, hk, dev)
    v_qs = _f32_vec(cache_v_quant_scales, hk, dev)
    k_ds = (_f32_vec(cache_k_dequant_scales, hk, dev)
            if cache_k_dequant_scales is not None
            else None if k_qs is None else 1.0 / k_qs)
    v_ds = (_f32_vec(cache_v_dequant_scales, hk, dev)
            if cache_v_dequant_scales is not None
            else None if v_qs is None else 1.0 / v_qs)
    if qkv_scale_v is not None:
        # the projection output dequantizes before the bias
        qkv = qkv.float() * qkv_scale_v[None, :]
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.to(qkv.dtype)[None, :]
    q = qkv[:, : h * d].reshape(-1, h, d)
    k_new = qkv[:, h * d: (h + hk) * d].reshape(-1, hk, d)
    v_new = qkv[:, (h + hk) * d:].reshape(-1, hk, d)
    if rotary_embs is not None:
        pos_t = dev_tensor(abs_pos, np.int64)[None]
        neox = bool(use_neox_rotary_style)
        q = apply_rotary_emb(q[None], rotary_embs[0], rotary_embs[1],
                             neox=neox, position_ids=pos_t)[0]
        k_new = apply_rotary_emb(k_new[None], rotary_embs[0],
                                 rotary_embs[1], neox=neox,
                                 position_ids=pos_t)[0]
    write_idx = (dev_tensor(blk_ids, np.int64), dev_tensor(offs, np.int64))
    if dyn_quant:
        # per-row quant, the same helper the decode quantum's writes use,
        # so a token's pool row and scale do not depend on the path
        k_store, k_sc = quantize_kv_rows(k_new)
        v_store, v_sc = quantize_kv_rows(v_new)
        cache_k_scale_pool.index_put_(write_idx, k_sc)
        cache_v_scale_pool.index_put_(write_idx, v_sc)
    elif quant_cache:
        k_store, v_store = _quant_static(k_new, k_qs), _quant_static(v_new,
                                                                      v_qs)
    else:
        k_store, v_store = k_new, v_new
    key_cache.index_put_(write_idx, k_store.to(key_cache.dtype))
    value_cache.index_put_(write_idx, v_store.to(value_cache.dtype))

    out = torch.zeros((total, h, d), dtype=q.dtype, device=dev)
    if len(pre_rows):
        pre_idx = dev_tensor(pre_tok, np.int64)
        ctx_idx = (dev_tensor(ctx_blk, np.int64),
                   dev_tensor(ctx_off, np.int64))
        k_ctx, v_ctx = key_cache[ctx_idx], value_cache[ctx_idx]
        if dyn_quant:
            k_ctx = k_ctx.float() * cache_k_scale_pool[ctx_idx][..., None]
            v_ctx = v_ctx.float() * cache_v_scale_pool[ctx_idx][..., None]
        elif quant_cache:
            k_ctx = k_ctx.float() * k_ds[None, :, None]
            v_ctx = v_ctx.float() * v_ds[None, :, None]
        o_pre = varlen_flash_attention(
            q[pre_idx], k_ctx.to(q.dtype), v_ctx.to(q.dtype),
            dev_tensor(cu_q_pre, np.int32), dev_tensor(cu_k_pre, np.int32),
            causal=True)
        out[pre_idx] = o_pre
    if len(dec_rows):
        dec_idx = dev_tensor(dec_tok, np.int64)
        o_dec = paged_decode_attention(
            q[dec_idx], key_cache, value_cache,
            dev_tensor(tbl_np[dec_rows], np.int32),
            dev_tensor(dec_lens[dec_rows] + 1, np.int32),
            k_scale=k_ds if quant_cache else None,
            v_scale=v_ds if quant_cache else None)
        out[dec_idx] = o_dec
    out = out.reshape(total, h * d)
    if out_shift is not None:
        out = out + _f32_vec(out_shift, h * d, dev)[None, :].to(out.dtype)
    if out_smooth is not None:
        out = out * _f32_vec(out_smooth, h * d, dev)[None, :].to(out.dtype)
    if out_scale is not None and float(out_scale) > 0:
        out = torch.clamp(torch.round(out.float() / float(out_scale)),
                          -128, 127).to(torch.int8)
    return out
