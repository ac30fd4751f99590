"""Paged KV-cache decode attention: the Hopper kernel K2 (float pools and
the int8 arm), its plain PyTorch versions, and the pool write.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``. The pool is
``(num_blocks, block_size, HK, D)`` shared by all sequences; each sequence
owns a row of ``block_tables``. Entries at or past a sequence's
``ceil(len / block_size)`` are arbitrary: the kernel never reads them and
the plain versions re-point them at block 0 before their gather, as the
TPU kernel's index map does. Static per-KV-head scales
(:func:`paged_decode_attention`'s ``k_scale``/``v_scale``, the TPU
kernel's ``has_scales`` arm) multiply the rows of float or int8 pools
inside the kernel; int8 pools also dequantize by the per-row scale
pools of the int8 serving engine (:func:`_paged_decode_attention_rows`,
whose plain version ports the reference engine's
``_xla_paged_decode_attn(ks=, vs=)``). The CUDA source is
``paddle_tpu_torch/csrc/paged_attention.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _library as L
from . import split_decode as SD

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_cache_write"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)  # D the kernel is built for
_MAX_GROUP = 8  # query heads per KV head the kernel takes (1..8)


def _gather(pool, tables, lens, bs):
    """(B, W * BS, ...) rows of each sequence's blocks in table order;
    entries past a sequence's blocks re-point at block 0 (masked later)."""
    w = tables.shape[1]
    nblk = torch.clamp((lens + bs - 1) // bs, max=w)
    live = torch.arange(w, device=lens.device)[None, :] < nblk[:, None]
    idx = torch.where(live, tables.to(lens.device, torch.long), 0)
    g = pool[idx]
    return g.reshape(g.shape[0], w * bs, *g.shape[3:])


def _attend(q, k, v, lens, sm_scale):
    """f32 masked softmax attention of q (B, H, D) over k/v (B, S, HK, D)
    f32, keys at or past ``lens`` masked; (B, H, D) in q's dtype."""
    b, h, d = q.shape
    hk = k.shape[2]
    qf = q.float().reshape(b, hk, h // hk, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k) * sm_scale
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v) / l
    return out.reshape(b, h, d).to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, seq_lens,
                                 sm_scale=None, k_scale=None, v_scale=None):
    """Plain version of K2: gather each sequence's live blocks (upcast to
    f32, times the (HK,) dequant scales where given) and run the same f32
    online-softmax math as one masked softmax. ``q`` is (B, H, D);
    returns (B, H, D) in the query's dtype."""
    d = q.shape[-1]
    bs, hk = k_pool.shape[1], k_pool.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lens = seq_lens.to(q.device, torch.long)
    k = _gather(k_pool, block_tables, lens, bs).float()
    v = _gather(v_pool, block_tables, lens, bs).float()
    if k_scale is not None or v_scale is not None:
        ks, vs = _head_scales(k_scale, v_scale, hk, q.device)
        k = k * ks[:, None]
        v = v * vs[:, None]
    return _attend(q, k, v, lens, sm_scale)


def _paged_decode_attention_rows_plain(q, k_pool, v_pool, k_scales,
                                       v_scales, block_tables, seq_lens,
                                       sm_scale=None):
    """Plain version of K2's per-row mode, the port of the reference
    engine's ``_xla_paged_decode_attn(ks=, vs=)``: each gathered int8 row
    dequantizes in f32 by its own scale from the (NB, BS, HK) scale
    pools before the f32 masked softmax."""
    d = q.shape[-1]
    bs = k_pool.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lens = seq_lens.to(q.device, torch.long)
    k = (_gather(k_pool, block_tables, lens, bs).float()
         * _gather(k_scales, block_tables, lens, bs)[..., None])
    v = (_gather(v_pool, block_tables, lens, bs).float()
         * _gather(v_scales, block_tables, lens, bs)[..., None])
    return _attend(q, k, v, lens, sm_scale)


def _head_scales(k_scale, v_scale, hk, device):
    """(HK,) f32 k and v dequant scales; a missing one is ones, as the
    reference's."""
    return tuple(torch.ones(hk, dtype=torch.float32, device=device)
                 if t is None
                 else torch.as_tensor(t, device=device).float().reshape(hk)
                 for t in (k_scale, v_scale))


def _check(name, q, k_pool, v_pool, block_tables, seq_lens):
    """Shape checks shared by both entry points."""
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    b, h, d = q.shape
    hk, pd = k_pool.shape[2], k_pool.shape[3]
    if pd != d or h % hk != 0:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({hk}) and "
            f"head dims must agree ({d} vs {pd})")
    if tuple(block_tables.shape[:1]) != (b,) or block_tables.dim() != 2 \
            or tuple(seq_lens.shape) != (b,):
        raise ValueError(
            f"{name}: tables {tuple(block_tables.shape)} "
            f"and lens {tuple(seq_lens.shape)} do not match batch {b}")


def _launch(name, q, k_pool, v_pool, block_tables, seq_lens, sm_scale,
            scales=None, per_row=False):
    """Check the kernel's inputs and launch K2 on the card: pools of q's
    dtype, without ``scales`` or with (HK,) ones, or int8 pools with (HK,)
    or (``per_row``) per-row scales."""
    L.refuse_grad(name, "decode attention is inference-only, as the "
                  "TPU kernel is", q, k_pool, v_pool)
    b, h, d = q.shape
    num_blocks, bs, hk = k_pool.shape[:3]
    int8 = k_pool.dtype == torch.int8
    if q.dtype not in _DTYPES or k_pool.dtype not in (q.dtype, torch.int8) \
            or v_pool.dtype != k_pool.dtype or (int8 and scales is None) \
            or (per_row and not int8):
        raise TypeError(
            f"{name} kernel takes float32 or bfloat16 q with pools of its "
            f"dtype, or int8 pools with scales (per-row scales only for "
            f"int8), got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"{name}: tables and lens must be int32")
    others = (k_pool, v_pool, block_tables, seq_lens) + tuple(scales or ())
    for t in others:
        if t.device != q.device:
            raise ValueError(f"{name}: inputs lie on different devices")
    if d not in _HEAD_DIMS or h // hk > _MAX_GROUP:
        raise NotImplementedError(
            f"{name} kernel takes head_dim in {_HEAD_DIMS} "
            f"and at most {_MAX_GROUP} query heads per kv head, got D={d}, "
            f"G={h // hk}")
    if scales is not None:
        want = tuple(k_pool.shape[:3]) if per_row else (hk,)
        if any(t.dtype != torch.float32 or tuple(t.shape) != want
               for t in scales):
            raise TypeError(f"{name}: scales must be float32 {want}")
    q = q.contiguous()
    if not all(t.is_contiguous() for t in others):
        raise ValueError(f"{name} kernel needs contiguous pools, scales, "
                         f"tables and lens")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError(f"{name} kernel needs 16-byte aligned q and pools")
    lib = L.library()
    w = block_tables.shape[1]
    splits = SD.plan_for(b * hk, w * bs, 2 * d * k_pool.element_size(),
                         q.device)
    stream = L.cuda_stream(q)
    ptrs, part = SD.workspace(splits, b * hk, h // hk, d, q.device,
                              stream.value or 0)
    out = torch.empty_like(q)
    scratch = (out.data_ptr(), *ptrs)
    geometry = (b, h, hk, d, num_blocks, bs, w, splits.stretch,
                splits.nsplit, float(sm_scale), _DTYPES[q.dtype])
    if scales is None:
        status = lib.ptt_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), *scratch,
            *geometry, stream)
    elif not int8:
        status = lib.ptt_paged_decode_attention_scaled(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            scales[0].data_ptr(), scales[1].data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), *scratch,
            *geometry, stream)
    else:
        status = lib.ptt_paged_decode_attention_int8(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            scales[0].data_ptr(), scales[1].data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), *scratch,
            *geometry, int(per_row), stream)
    L.check_status(name, status)
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, seq_lens,
                           sm_scale=None, k_scale=None, v_scale=None):
    """One-step decode attention over a paged KV pool.

    Args:
        q: (B, H, D) or (B, 1, H, D), the new token's query heads.
        k_pool, v_pool: (num_blocks, block_size, HK, D) pools, float or
            int8.
        block_tables: (B, max_blocks) int32 pool block ids per sequence.
        seq_lens: (B,) int32 valid tokens per sequence (the decoded one
            included).
        k_scale, v_scale: optional (HK,) f32 per-KV-head dequant scales,
            applied inside the kernel to float or int8 pools (the int8
            pools stay int8 in memory); with only one given the other is
            ones, and int8 pools without either run at scale 1, as in the
            reference.
    Returns (B, H, D) (or (B, 1, H, D) matching q) in the query's dtype.
    CPU tensors run :func:`paged_decode_attention_plain`; CUDA tensors
    launch the kernel or raise."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    _check("paged_decode_attention", q, k_pool, v_pool, block_tables,
           seq_lens)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    int8 = k_pool.dtype == torch.int8
    if L.use_plain(q):
        out = paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                           seq_lens, sm_scale, k_scale,
                                           v_scale)
    elif int8:
        scales = _head_scales(k_scale, v_scale, k_pool.shape[2], q.device)
        out = _launch("paged_decode_attention_int8", q, k_pool, v_pool,
                      block_tables, seq_lens, sm_scale, scales)
        L.LAUNCHES["paged_decode_attention_int8"] += 1
    elif k_scale is not None or v_scale is not None:
        scales = _head_scales(k_scale, v_scale, k_pool.shape[2], q.device)
        out = _launch("paged_decode_attention_scaled", q, k_pool, v_pool,
                      block_tables, seq_lens, sm_scale, scales)
        L.LAUNCHES["paged_decode_attention_scaled"] += 1
    else:
        out = _launch("paged_decode_attention", q, k_pool, v_pool,
                      block_tables, seq_lens, sm_scale)
        L.LAUNCHES["paged_decode_attention"] += 1
    return out[:, None] if squeeze else out


def _paged_decode_attention_rows(q, k_pool, v_pool, k_scales, v_scales,
                                 block_tables, seq_lens, sm_scale=None):
    """K2's per-row mode, the int8 serving engine's decode attention:
    int8 pools with (num_blocks, block_size, HK) f32 scale pools, one
    scale per pool row, read beside the row inside the kernel. ``q`` is
    (B, H, D). CPU tensors run
    :func:`_paged_decode_attention_rows_plain`; CUDA tensors launch the
    kernel or raise."""
    _check("paged_decode_attention_int8_rows", q, k_pool, v_pool,
           block_tables, seq_lens)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if L.use_plain(q):
        return _paged_decode_attention_rows_plain(
            q, k_pool, v_pool, k_scales, v_scales, block_tables, seq_lens,
            sm_scale)
    out = _launch("paged_decode_attention_int8_rows", q, k_pool, v_pool,
                  block_tables, seq_lens, sm_scale, (k_scales, v_scales),
                  per_row=True)
    L.LAUNCHES["paged_decode_attention_int8_rows"] += 1
    return out


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
