"""Paged KV-cache decode attention: the Hopper kernel K2, its plain
PyTorch version, and the pool write.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``. The pool is
``(num_blocks, block_size, HK, D)`` shared by all sequences; each sequence
owns a row of ``block_tables``. Entries at or past a sequence's
``ceil(len / block_size)`` are arbitrary: the kernel never reads them and
the plain version re-points them at block 0 before its gather, as the
TPU kernel's index map does. The CUDA source is
``paddle_tpu_torch/csrc/paged_attention.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _library as L

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_cache_write"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)  # D the kernel is built for (D / 32 dims per lane)
_MAX_GROUP = 8          # query heads per KV head the kernel holds


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, seq_lens,
                                 sm_scale=None):
    """Plain version of K2: gather each sequence's live blocks and run the
    same f32 online-softmax math as one masked softmax. ``q`` is (B, H, D);
    returns (B, H, D) in the query's dtype."""
    b, h, d = q.shape
    _, bs, hk, _ = k_pool.shape
    g = h // hk
    w = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    lens = seq_lens.to(dev, torch.long)
    nblk = torch.clamp((lens + bs - 1) // bs, max=w)
    live = torch.arange(w, device=dev)[None, :] < nblk[:, None]
    tables = torch.where(live, block_tables.to(dev, torch.long), 0)
    k = k_pool[tables].reshape(b, w * bs, hk, d).float()
    v = v_pool[tables].reshape(b, w * bs, hk, d).float()
    qf = q.float().reshape(b, hk, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k) * sm_scale
    mask = (torch.arange(w * bs, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v) / l
    return out.reshape(b, h, d).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_tables, seq_lens,
                           sm_scale=None, k_scale=None, v_scale=None):
    """One-step decode attention over a paged KV pool.

    Args:
        q: (B, H, D) or (B, 1, H, D), the new token's query heads.
        k_pool, v_pool: (num_blocks, block_size, HK, D) pools.
        block_tables: (B, max_blocks) int32 pool block ids per sequence.
        seq_lens: (B,) int32 valid tokens per sequence (the decoded one
            included).
        k_scale, v_scale: the int8 pools' per-head dequant scales; they
            belong to the int8 serving slice and raise here.
    Returns (B, H, D) (or (B, 1, H, D) matching q) in the query's dtype.
    CPU tensors run :func:`paged_decode_attention_plain`; CUDA tensors
    launch the kernel or raise."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "paged_decode_attention: int8 pools with k_scale/v_scale come "
            "with the int8 serving slice (ROADMAP K2 int8 arm)")
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    b, h, d = q.shape
    num_blocks, bs, hk, pd = k_pool.shape
    if pd != d or h % hk != 0:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({hk}) and "
            f"head dims must agree ({d} vs {pd})")
    if tuple(block_tables.shape[:1]) != (b,) or block_tables.dim() != 2 \
            or tuple(seq_lens.shape) != (b,):
        raise ValueError(
            f"paged_decode_attention: tables {tuple(block_tables.shape)} "
            f"and lens {tuple(seq_lens.shape)} do not match batch {b}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if L.use_plain(q):
        out = paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                           seq_lens, sm_scale)
        return out[:, None] if squeeze else out
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_decode_attention kernel takes float32 or bfloat16 q and "
            f"pools of the same dtype, got {q.dtype}, {k_pool.dtype}, "
            f"{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention: tables and lens must be "
                        "int32")
    for t in (k_pool, v_pool, block_tables, seq_lens):
        if t.device != q.device:
            raise ValueError("paged_decode_attention: inputs lie on "
                             "different devices")
    if d not in _HEAD_DIMS or h // hk > _MAX_GROUP:
        raise NotImplementedError(
            f"paged_decode_attention kernel takes head_dim in {_HEAD_DIMS} "
            f"and at most {_MAX_GROUP} query heads per kv head, got D={d}, "
            f"G={h // hk}")
    q = q.contiguous()
    if not all(t.is_contiguous() for t in (k_pool, v_pool, block_tables,
                                           seq_lens)):
        raise ValueError("paged_decode_attention kernel needs contiguous "
                         "pools, tables and lens")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_decode_attention kernel needs 16-byte "
                         "aligned q and pools")
    lib = L.library()
    w = block_tables.shape[1]
    nsplit = -(-w * bs // L.PAGED_SPLIT_TOKENS)
    # per-split partial results (G x D accumulators, then G x (max, sum)),
    # merged by the kernel's second pass
    n_o = b * hk * nsplit * (h // hk) * d
    part = torch.empty(n_o + b * hk * nsplit * (h // hk) * 2,
                       dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    status = lib.ptt_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), part[n_o:].data_ptr(), b, h, hk, d, num_blocks,
        bs, w, nsplit, float(sm_scale), _DTYPES[q.dtype], L.cuda_stream(q))
    L.check_status("paged_decode_attention", status)
    L.LAUNCHES["paged_decode_attention"] += 1
    return out[:, None] if squeeze else out


def paged_cache_write(k_pool, v_pool, k_new, v_new, block_tables, positions):
    """Write one new token's K/V per sequence into the pools IN PLACE
    (the reference returns new arrays; here ``index_put_`` updates the
    pool tensors themselves). ``k_new``/``v_new`` (B, HK, D); positions
    (B,) absolute token index, already mapped by the block table.
    Returns the (same) pools."""
    bs = k_pool.shape[1]
    pos = positions.to(torch.long)
    blk = block_tables.to(torch.long).gather(1, (pos // bs)[:, None])[:, 0]
    off = pos % bs
    k_pool.index_put_((blk, off), k_new.to(k_pool.dtype))
    v_pool.index_put_((blk, off), v_new.to(v_pool.dtype))
    return k_pool, v_pool
