"""Serving attention ops and the fused training loss (counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``): the one-token decode op
``masked_multihead_attention`` over a contiguous cache,
``block_multihead_attention`` over the paged KV pool (float-pool path), and
``fused_linear_cross_entropy``."""
from __future__ import annotations

import numpy as np
import torch

from ....nn.functional.rope import apply_rotary_emb
from ....ops.decode_attention import decode_attention, decode_attention_plain
from ....ops.paged_attention import paged_decode_attention
from ....ops.varlen_flash_attention import varlen_flash_attention
from .fused_linear_cross_entropy import fused_linear_cross_entropy

__all__ = ["masked_multihead_attention", "block_multihead_attention",
           "fused_linear_cross_entropy"]

# the reference's int8 / static-scale / out-quant epilogue kwargs: they
# belong to the int8 serving slice
_QUANT_KWARGS = ("qkv_out_scale", "cache_k_quant_scales",
                 "cache_v_quant_scales", "cache_k_dequant_scales",
                 "cache_v_dequant_scales", "out_shift", "out_smooth",
                 "cache_k_scale_pool", "cache_v_scale_pool")


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


def block_multihead_attention(qkv, key_cache, value_cache,
                              seq_lens_encoder, seq_lens_decoder,
                              seq_lens_this_time, padding_offsets=None,
                              cum_offsets=None, cu_seqlens_q=None,
                              cu_seqlens_k=None, block_tables=None,
                              max_seq_len=None, block_size=None,
                              use_neox_rotary_style=False, num_heads=None,
                              kv_num_heads=None, head_dim=None,
                              rotary_embs=None, qkv_bias=None, **kwargs):
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
        key_cache/value_cache: (num_blocks, block_size, HK, D) pools.
        seq_lens_encoder: (B,) prefill token counts (0 for decode rows).
        seq_lens_decoder: (B,) tokens already in cache.
        seq_lens_this_time: (B,) tokens entering this call per sequence.
        block_tables: (B, max_blocks) int32 pool block ids.
        rotary_embs: optional (2, max_seq_len, D/2) cos/sin table, applied
            to this call's q/k at their absolute positions.
        qkv_bias: optional ((H + 2*HK) * D,) bias added before the rope.
        ``padding_offsets``, ``cum_offsets``, ``cu_seqlens_q/k``,
        ``max_seq_len`` and ``block_size`` are accepted for signature
        parity and derived from the lengths, as in the reference.
    Returns the attention output (total_tokens, H * D).
    """
    for name in _QUANT_KWARGS:
        if kwargs.pop(name, None) is not None:
            raise NotImplementedError(
                f"block_multihead_attention: {name} belongs to the int8 "
                f"serving slice (ROADMAP A9)")
    out_scale = kwargs.pop("out_scale", -1)
    if out_scale is not None and out_scale > 0:
        raise NotImplementedError(
            "block_multihead_attention: the int8 output epilogue belongs to "
            "the int8 serving slice (ROADMAP A9)")
    if kwargs:
        raise TypeError(f"unexpected arguments {sorted(kwargs)}")
    if key_cache.dtype != value_cache.dtype:
        raise ValueError(
            f"key_cache ({key_cache.dtype}) and value_cache "
            f"({value_cache.dtype}) dtypes must match")
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
    key_cache.index_put_(write_idx, k_new.to(key_cache.dtype))
    value_cache.index_put_(write_idx, v_new.to(value_cache.dtype))

    out = torch.zeros((total, h, d), dtype=q.dtype, device=dev)
    if len(pre_rows):
        pre_idx = dev_tensor(pre_tok, np.int64)
        ctx_idx = (dev_tensor(ctx_blk, np.int64),
                   dev_tensor(ctx_off, np.int64))
        o_pre = varlen_flash_attention(
            q[pre_idx], key_cache[ctx_idx].to(q.dtype),
            value_cache[ctx_idx].to(q.dtype),
            dev_tensor(cu_q_pre, np.int32), dev_tensor(cu_k_pre, np.int32),
            causal=True)
        out[pre_idx] = o_pre
    if len(dec_rows):
        dec_idx = dev_tensor(dec_tok, np.int64)
        o_dec = paged_decode_attention(
            q[dec_idx], key_cache, value_cache,
            dev_tensor(tbl_np[dec_rows], np.int32),
            dev_tensor(dec_lens[dec_rows] + 1, np.int32))
        out[dec_idx] = o_dec
    return out.reshape(total, h * d)
