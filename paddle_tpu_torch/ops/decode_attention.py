"""Contiguous-cache decode attention: the Hopper kernel K5 and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``. One query
token per batch row attends its cache ``(B, S_max, HK, D)`` up to
``seq_lens[b]`` (the decoded token included); the ``H / HK`` query heads of
a GQA group share a KV head. The math is f32 throughout: q, k and v are
upcast, P is not rounded, the row sum is clamped at ``1e-30`` (a row with
no live key returns zeros), and the output is in q's dtype. The CUDA
source is ``paddle_tpu_torch/csrc/decode_attention.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _library as L
from . import split_decode as SD

__all__ = ["decode_attention", "decode_attention_plain"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)  # D the kernel is built for
_MAX_GROUP = 8  # query heads per KV head the kernel takes (1..8)


def decode_attention_plain(q, k_cache, v_cache, seq_lens, sm_scale=None,
                           bias=None):
    """Plain version of K5: one masked softmax in f32. ``q`` is (B, H, D)
    or (B, 1, H, D) and the result has q's shape and dtype. ``bias`` is an
    optional additive f32 logits bias broadcastable to (B, H, 1, S_max),
    added before the length mask (``_masked_decode_attn``'s ``bias``)."""
    squeeze = q.dim() == 4
    q3 = q[:, 0] if squeeze else q
    b, h, d = q3.shape
    s_max, hk = k_cache.shape[1], k_cache.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = q3.float().reshape(b, hk, h // hk, d)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float()) * sm_scale
    s = s.reshape(b, h, 1, s_max)
    if bias is not None:
        s = s + bias.float()
    lens = seq_lens.to(q.device, torch.long)
    mask = (torch.arange(s_max, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskd->bkgd",
                       p.reshape(b, hk, h // hk, s_max),
                       v_cache.float()) / l.reshape(b, hk, h // hk, 1)
    out = out.reshape(b, h, d).to(q.dtype)
    return out[:, None] if squeeze else out


def decode_attention(q, k_cache, v_cache, seq_lens, sm_scale=None):
    """One-step decode attention over a contiguous KV cache.

    Args:
        q: (B, H, D) or (B, 1, H, D), the new token's query heads.
        k_cache, v_cache: (B, S_max, HK, D) paddle cache layout, H % HK == 0.
        seq_lens: (B,) int32 valid cache entries per row (the decoded token
            included, already written).
    Returns (B, H, D) (or (B, 1, H, D) matching q) in q's dtype. CPU
    tensors run :func:`decode_attention_plain`; CUDA tensors launch the
    kernel or raise. A q whose dtype differs from the cache's (bf16
    queries over the f32 caches of ``greedy_search``) is cast to the
    cache's dtype for the kernel, which computes in f32 either way."""
    L.refuse_trace("decode_attention")
    squeeze = q.dim() == 4
    q3 = q[:, 0] if squeeze else q
    if q3.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    b, h, d = q3.shape
    cb, s_max, hk, cd = k_cache.shape
    if cb != b or cd != d or h % hk != 0:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({hk}), and "
            f"batch and head dims must agree (q {tuple(q.shape)}, cache "
            f"{tuple(k_cache.shape)})")
    if tuple(seq_lens.shape) != (b,):
        raise ValueError(f"decode_attention: seq_lens {tuple(seq_lens.shape)}"
                         f" does not match batch {b}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if L.use_plain(q3):
        return decode_attention_plain(q, k_cache, v_cache, seq_lens,
                                      sm_scale)
    L.refuse_grad("decode_attention",
                  "decode attention is inference-only, as the TPU kernel "
                  "is", q, k_cache, v_cache)
    if k_cache.dtype not in _DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(
            f"decode_attention kernel takes float32 or bfloat16 caches of "
            f"one dtype, got {k_cache.dtype}, {v_cache.dtype}")
    if q3.dtype not in _DTYPES:
        raise TypeError(f"decode_attention kernel takes a float32 or "
                        f"bfloat16 query, got {q3.dtype}")
    if seq_lens.dtype != torch.int32:
        raise TypeError("decode_attention: seq_lens must be int32")
    for t in (k_cache, v_cache, seq_lens):
        if t.device != q3.device:
            raise ValueError("decode_attention: inputs lie on different "
                             "devices")
    if d not in _HEAD_DIMS or h // hk > _MAX_GROUP:
        raise NotImplementedError(
            f"decode_attention kernel takes head_dim in {_HEAD_DIMS} and "
            f"at most {_MAX_GROUP} query heads per kv head, got D={d}, "
            f"G={h // hk} (other widths: ROADMAP A10)")
    if not all(t.is_contiguous() for t in (k_cache, v_cache, seq_lens)):
        raise ValueError("decode_attention kernel needs contiguous caches "
                         "and lens")
    qk = q3.to(k_cache.dtype).contiguous()
    if any(t.data_ptr() % 16 for t in (qk, k_cache, v_cache)):
        raise ValueError("decode_attention kernel needs 16-byte aligned q "
                         "and caches")
    lib = L.library()
    g = h // hk
    splits = SD.plan_for(b * hk, s_max, 2 * d * k_cache.element_size(),
                         q3.device)
    stream = L.cuda_stream(q3)
    ptrs, part = SD.workspace(splits, b * hk, g, d, q3.device,
                              stream.value or 0)
    out = torch.empty_like(qk)
    status = lib.ptt_decode_attention(
        qk.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), *ptrs, b, h, hk, d, s_max,
        splits.stretch, splits.nsplit, float(sm_scale),
        _DTYPES[k_cache.dtype], stream)
    L.check_status("decode_attention", status)
    L.LAUNCHES["decode_attention"] += 1
    out = out.to(q3.dtype)
    return out[:, None] if squeeze else out
