"""Varlen (packed) flash attention forward: the Hopper kernel K3 and its
plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/varlen_flash_attention.py``
(forward; the backward kernels belong to the training slice). Sequences
are packed back to back, ``q`` (total_q, H, D) and ``k``/``v``
(total_k, HK, D), with ``cu_seqlens`` prefix sums; attention never crosses
a segment, causal masks are bottom-right aligned per segment
(``rel_q = pos - start_q + len_k - len_q``), and ``window_size`` applies
the sliding-window band per segment. Rows that see no key return zeros.
The CUDA source is ``paddle_tpu_torch/csrc/varlen_flash_attention.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _library as L

__all__ = ["varlen_flash_attention", "varlen_flash_attention_plain",
           "segment_mask", "varlen_flash_attention_bwd",
           "varlen_flash_attention_bwd_dq", "varlen_flash_attention_bwd_dkv",
           "varlen_flash_attention_bwd_delta",
           "varlen_flash_attention_bwd_plain", "VarlenFlashAttentionFunction"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_BWD_HEAD_DIMS = (64, 128)
_TILE = 64  # rows per tile of the kernels (their tile-order scratch)


def segment_mask(cu_seqlens_q, cu_seqlens_k, tq, tk, causal, window=None):
    """(tq, tk) bool mask of live (query, key) pairs: same segment and,
    for causal, bottom-right aligned relative positions (and the window
    band). Padding rows past ``cu[-1]`` see nothing."""
    dev = cu_seqlens_q.device
    cu_q = cu_seqlens_q.to(torch.long)
    cu_k = cu_seqlens_k.to(dev, torch.long)
    nseg = cu_q.numel() - 1
    pos_q = torch.arange(tq, device=dev)
    pos_k = torch.arange(tk, device=dev)
    seg_q = torch.searchsorted(cu_q[1:], pos_q, right=True)
    seg_k = torch.searchsorted(cu_k[1:], pos_k, right=True)
    sq = seg_q.clamp(max=nseg - 1)
    sk = seg_k.clamp(max=nseg - 1)
    mask = (seg_q[:, None] == seg_k[None, :]) \
        & (pos_q < cu_q[-1])[:, None] & (pos_k < cu_k[-1])[None, :]
    if causal:
        rel_q = pos_q - cu_q[sq] + (cu_k[sq + 1] - cu_k[sq]) \
            - (cu_q[sq + 1] - cu_q[sq])
        rel_k = pos_k - cu_k[sk]
        mask &= rel_q[:, None] >= rel_k[None, :]
        if window is not None:
            mask &= rel_k[None, :] > rel_q[:, None] - window
    return mask


def varlen_flash_attention_plain(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                 causal=False, sm_scale=None,
                                 window_size=None):
    """Plain version of K3 (dense masked softmax in f32; the
    probabilities are rounded to v's dtype before the product with v, as
    the TPU kernel does). Returns ``(out, lse)``: out (total_q, H, D) in
    q's dtype, lse (H, total_q) f32."""
    tq, h, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    mask = segment_mask(cu_seqlens_q.to(q.device), cu_seqlens_k, tq, tk,
                        causal, window_size)[None]
    kf = k.float().repeat_interleave(h // hk, dim=1)
    vr = v.repeat_interleave(h // hk, dim=1)
    s = torch.einsum("qhd,khd->hqk", q.float(), kf) * sm_scale
    s = s.masked_fill(~mask, NEG_INF)
    m = (s.amax(dim=-1, keepdim=True) if tk
         else torch.full((h, tq, 1), NEG_INF, device=q.device))
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("hqk,khd->qhd", p.to(v.dtype).float(),
                       vr.float()) / l.transpose(0, 1)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype).contiguous(), lse


def varlen_flash_attention(q, k, v, cu_seqlens_q, cu_seqlens_k,
                           causal=False, sm_scale=None, window_size=None,
                           return_lse=False):
    """Packed varlen attention, (total_q, H, D) out.

    ``cu_seqlens_q/k`` are (B+1,) int32 prefix sums on q's device.
    CPU tensors run :func:`varlen_flash_attention_plain`; CUDA tensors
    launch the kernel or raise. With ``return_lse`` also returns the
    (H, total_q) f32 log-sum-exp the kernel writes."""
    if window_size is not None and not causal:
        raise ValueError("window_size requires causal=True")
    if window_size is not None and window_size < 1:
        raise ValueError(f"window_size must be >= 1, got {window_size}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(
            f"varlen_flash_attention: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}")
    tq, h, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
    if h % hk != 0 or k.shape[2] != d:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({hk}) and "
            f"head dims must agree")
    if cu_seqlens_q.shape != cu_seqlens_k.shape or cu_seqlens_q.dim() != 1:
        raise ValueError("cu_seqlens_q and cu_seqlens_k must be (B+1,)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if L.use_plain(q):
        out, lse = varlen_flash_attention_plain(
            q, k, v, cu_seqlens_q, cu_seqlens_k, causal, sm_scale,
            window_size)
        return (out, lse) if return_lse else out
    L.refuse_grad("varlen_flash_attention",
                  "its backward K8a/K8b runs through "
                  "VarlenFlashAttentionFunction, or F.flash_attn_unpadded",
                  q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"varlen_flash_attention kernel takes float32 or bfloat16 q, k, "
            f"v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > _MAX_HEAD_DIM or d % 16:
        raise NotImplementedError(
            f"varlen_flash_attention kernel takes head_dim <= "
            f"{_MAX_HEAD_DIM} and a multiple of 16, got {d}")
    for t in (k, v, cu_seqlens_q, cu_seqlens_k):
        if t.device != q.device:
            raise ValueError("varlen_flash_attention: inputs lie on "
                             "different devices")
    if cu_seqlens_q.dtype != torch.int32 or cu_seqlens_k.dtype != torch.int32:
        raise TypeError("varlen_flash_attention: cu_seqlens must be int32")
    if not all(t.is_contiguous() for t in (q, k, v, cu_seqlens_q,
                                           cu_seqlens_k)):
        raise ValueError("varlen_flash_attention kernel needs contiguous "
                         "inputs")
    out = torch.empty_like(q)
    lse = torch.empty((h, tq), dtype=torch.float32, device=q.device)
    order = _order_scratch(tq, q)
    status = L.library().ptt_varlen_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cu_seqlens_q.data_ptr(),
        cu_seqlens_k.data_ptr(), order.data_ptr(), out.data_ptr(),
        lse.data_ptr(), tq, tk,
        cu_seqlens_q.shape[0] - 1, h, hk, d, int(bool(causal)),
        int(window_size or 0), float(sm_scale), _DTYPES[q.dtype],
        L.cuda_stream(q))
    L.check_status("varlen_flash_attention", status)
    L.LAUNCHES["varlen_flash_attention"] += 1
    return (out, lse) if return_lse else out


def varlen_flash_attention_bwd_delta(out, do):
    """``delta = rowsum(do * out)`` in f32, (H, total_q): the backward's
    per-row term (a torch op, as the reference computes it outside
    Pallas)."""
    return (do.float() * out.float()).sum(-1).t().contiguous()


def varlen_flash_attention_bwd_plain(q, k, v, out, lse, do, cu_seqlens_q,
                                     cu_seqlens_k, causal=False,
                                     sm_scale=None, window_size=None,
                                     delta=None):
    """Plain version of K8a/K8b (the reference's ``_varlen_bwd``): returns
    ``(dq, dk, dv)`` like q, k, v. P is recomputed from ``lse`` (H,
    total_q) in f32 and taken to 0 on dead pairs by a select (a row with no
    live key has lse about -1e30, where exp overflows); ``delta`` (default
    from ``out``) is f32. P is rounded to do's dtype before dV, dS to k's
    dtype before dQ and to q's dtype before dK; products accumulate in f32.
    A GQA group's query heads are summed into their KV head's dk and dv in
    f32 before the one rounding to the input dtype."""
    tq, h, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if delta is None:
        delta = varlen_flash_attention_bwd_delta(out, do)
    g = h // hk
    mask = segment_mask(cu_seqlens_q.to(q.device), cu_seqlens_k, tq, tk,
                        causal, window_size)
    qf = q.float().reshape(tq, hk, g, d)
    dof = do.float().reshape(tq, hk, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("qkgd,skd->kgqs", qf, kf) * sm_scale
    p = torch.where(mask, torch.exp(s - lse.reshape(hk, g, tq, 1)), 0.0)
    dp = torch.einsum("qkgd,skd->kgqs", dof, vf)
    ds = p * (dp - delta.reshape(hk, g, tq, 1)) * sm_scale
    dv = torch.einsum("kgqs,qkgd->skd", p.to(do.dtype).float(), dof)
    dq = torch.einsum("kgqs,skd->qkgd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("kgqs,qkgd->skd", ds.to(q.dtype).float(), qf)
    return (dq.reshape(tq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_launch_args(q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k,
                     causal, sm_scale, window_size):
    if window_size is not None and not causal:
        raise ValueError("window_size requires causal=True")
    tq, h, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
    if k.dim() != 3 or v.shape != k.shape or k.shape[2] != d \
            or h % hk != 0 or do.shape != q.shape \
            or lse.shape != (h, tq) or delta.shape != (h, tq):
        raise ValueError(
            f"varlen_flash_attention backward: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, do {tuple(do.shape)}, "
            f"lse {tuple(lse.shape)}, delta {tuple(delta.shape)}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, do)):
        raise TypeError(
            f"varlen_flash_attention backward kernels take float32 or "
            f"bfloat16 q, k, v, do of one dtype, got "
            f"{[t.dtype for t in (q, k, v, do)]}")
    if d not in _BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"varlen_flash_attention backward kernels take head_dim in "
            f"{_BWD_HEAD_DIMS}, got {d}")
    for t in (lse, delta):
        if t.dtype != torch.float32:
            raise TypeError("varlen_flash_attention backward kernels take "
                            "f32 lse and delta")
    if cu_seqlens_q.shape != cu_seqlens_k.shape or cu_seqlens_q.dim() != 1 \
            or cu_seqlens_q.dtype != torch.int32 \
            or cu_seqlens_k.dtype != torch.int32:
        raise TypeError("varlen_flash_attention backward: cu_seqlens must "
                        "be (B+1,) int32")
    tensors = (q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k)
    if any(t.device != q.device for t in tensors):
        raise ValueError("varlen_flash_attention backward: inputs lie on "
                         "different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("varlen_flash_attention backward kernels need "
                         "contiguous inputs")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    ptrs = tuple(t.data_ptr() for t in tensors)
    dims = (tq, tk, cu_seqlens_q.shape[0] - 1, h, hk, d, int(bool(causal)),
            int(window_size or 0), float(sm_scale), _DTYPES[q.dtype],
            L.cuda_stream(q))
    return ptrs, dims


def _order_scratch(rows, like):
    """int32 scratch for the kernels' tile order (one entry per 64 rows)."""
    return torch.empty((rows + _TILE - 1) // _TILE, dtype=torch.int32,
                       device=like.device)


def varlen_flash_attention_bwd_dq(q, k, v, do, lse, delta, cu_seqlens_q,
                                  cu_seqlens_k, causal=False, sm_scale=None,
                                  window_size=None):
    """K8a: dq (like q) from the forward's ``lse`` and ``delta``
    (:func:`varlen_flash_attention_bwd_delta`). CPU tensors run the plain
    backward; CUDA tensors launch the kernel or raise."""
    if L.use_plain(q):
        return varlen_flash_attention_bwd_plain(
            q, k, v, None, lse, do, cu_seqlens_q, cu_seqlens_k, causal,
            sm_scale, window_size, delta)[0]
    ptrs, dims = _bwd_launch_args(q, k, v, do, lse, delta, cu_seqlens_q,
                                  cu_seqlens_k, causal, sm_scale, window_size)
    dq = torch.empty_like(q)
    order = _order_scratch(q.shape[0], q)
    status = L.library().ptt_varlen_flash_attention_bwd_dq(
        *ptrs, order.data_ptr(), dq.data_ptr(), *dims)
    L.check_status("varlen_flash_attention_bwd_dq", status)
    L.LAUNCHES["varlen_flash_attention_bwd_dq"] += 1
    return dq


def varlen_flash_attention_bwd_dkv(q, k, v, do, lse, delta, cu_seqlens_q,
                                   cu_seqlens_k, causal=False, sm_scale=None,
                                   window_size=None):
    """K8b: ``(dk, dv)`` (like k, v), each KV head's sum over the query
    heads of its group. CPU tensors run the plain backward; CUDA tensors
    launch the kernel or raise."""
    if L.use_plain(q):
        return varlen_flash_attention_bwd_plain(
            q, k, v, None, lse, do, cu_seqlens_q, cu_seqlens_k, causal,
            sm_scale, window_size, delta)[1:]
    ptrs, dims = _bwd_launch_args(q, k, v, do, lse, delta, cu_seqlens_q,
                                  cu_seqlens_k, causal, sm_scale, window_size)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    order = _order_scratch(k.shape[0], k)
    status = L.library().ptt_varlen_flash_attention_bwd_dkv(
        *ptrs, order.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims)
    L.check_status("varlen_flash_attention_bwd_dkv", status)
    L.LAUNCHES["varlen_flash_attention_bwd_dkv"] += 1
    return dk, dv


def varlen_flash_attention_bwd(q, k, v, out, lse, do, cu_seqlens_q,
                               cu_seqlens_k, causal=False, sm_scale=None,
                               window_size=None):
    """Gradients ``(dq, dk, dv)`` of varlen attention from the forward's
    ``out`` and ``lse`` and the upstream ``do`` (like q): delta, then K8a
    and K8b on CUDA tensors, :func:`varlen_flash_attention_bwd_plain` on
    CPU tensors."""
    if out.shape != q.shape:
        raise ValueError(f"varlen_flash_attention_bwd: out "
                         f"{tuple(out.shape)} for q {tuple(q.shape)}")
    if L.use_plain(q):
        return varlen_flash_attention_bwd_plain(
            q, k, v, out, lse, do, cu_seqlens_q, cu_seqlens_k, causal,
            sm_scale, window_size)
    delta = varlen_flash_attention_bwd_delta(out, do)
    args = (q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, causal,
            sm_scale, window_size)
    dq = varlen_flash_attention_bwd_dq(*args)
    dk, dv = varlen_flash_attention_bwd_dkv(*args)
    return dq, dk, dv


class VarlenFlashAttentionFunction(torch.autograd.Function):
    """``out = varlen_flash_attention(q, k, v, cu_seqlens_q, cu_seqlens_k,
    causal, sm_scale, window_size)`` with K8a/K8b as its backward (the
    reference's ``_varlen_htd`` custom_vjp: the forward keeps q, k, v, out
    and lse, the backward recomputes P from lse). The cu_seqlens get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cu_seqlens_q, cu_seqlens_k, causal=False,
                sm_scale=None, window_size=None):
        out, lse = varlen_flash_attention(q, k, v, cu_seqlens_q,
                                          cu_seqlens_k, causal, sm_scale,
                                          window_size, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, cu_seqlens_q, cu_seqlens_k)
        ctx.args = (causal, sm_scale, window_size)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, cu_q, cu_k = ctx.saved_tensors
        # the upstream gradient arrives as a (T, H, D) view of whatever the
        # caller reshaped; the kernels read it as packed rows
        dq, dk, dv = varlen_flash_attention_bwd(
            q, k, v, out, lse, do.to(q.dtype).contiguous(), cu_q, cu_k,
            *ctx.args)
        return dq, dk, dv, None, None, None, None, None
