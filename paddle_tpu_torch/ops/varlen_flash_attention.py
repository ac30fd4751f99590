"""Varlen (packed) flash attention: the Hopper kernels K3 (forward) and K8
(the fused backward: on wgmma in bf16, as 3xTF32 in f32), their plain
PyTorch versions, and the fused backward's work order.

Counterpart of ``paddle_tpu/ops/pallas/varlen_flash_attention.py``.
Sequences are packed back to back, ``q`` (total_q, H, D) and ``k``/``v``
(total_k, HK, D), with ``cu_seqlens`` prefix sums; attention never crosses
a segment, causal masks are bottom-right aligned per segment
(``rel_q = pos - start_q + len_k - len_q``), and ``window_size`` applies
the sliding-window band per segment. Rows that see no key return zeros.
The CUDA sources are ``paddle_tpu_torch/csrc/varlen_flash_attention.cu``
and ``varlen_flash_attention_bwd.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _library as L

__all__ = ["varlen_flash_attention", "varlen_flash_attention_plain",
           "segment_mask", "varlen_flash_attention_bwd",
           "varlen_flash_attention_bwd_fused",
           "varlen_flash_attention_bwd_dq", "varlen_flash_attention_bwd_dkv",
           "varlen_flash_attention_bwd_delta",
           "varlen_flash_attention_bwd_plain", "VarlenBwdSchedule",
           "VarlenFlashAttentionFunction"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_BWD_HEAD_DIMS = (64, 128)
_TILE = 64  # rows per tile of the kernels (their tile-order scratch)


def _bwd_block_k(d):
    """Keys per CTA of the fused backward K8 at head width d, in bf16 and
    f32: 64 at d = 64 (two bf16 or three f32 CTAs share an SM), else
    128."""
    return 64 if d == 64 else 128


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
    how = L.route(q, k, v)
    if how == "plain":
        out, lse = varlen_flash_attention_plain(
            q, k, v, cu_seqlens_q, cu_seqlens_k, causal, sm_scale,
            window_size)
        return (out, lse) if return_lse else out
    if q.device.type == "cuda":
        L.refuse_grad("varlen_flash_attention",
                      "its backward K8 runs through "
                      "VarlenFlashAttentionFunction, or F.flash_attn_unpadded",
                      q, k, v)
    fn = (_varlen_cuda if how == "kernel"
          else torch.ops.paddle_tpu_torch.varlen_flash_attention.default)
    out, lse = fn(q, k, v, cu_seqlens_q, cu_seqlens_k, bool(causal),
                  float(sm_scale), int(window_size or 0))
    return (out, lse) if return_lse else out


def _fwd_kernel_check(q, k, v, cu_seqlens_q, cu_seqlens_k):
    d = q.shape[-1]
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


def _varlen_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cu_seqlens_q: torch.Tensor, cu_seqlens_k: torch.Tensor,
                 causal: bool, sm_scale: float,
                 window_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 as a custom op: ``(out, lse)`` (``window_size`` 0: no window).
    On CUDA tensors it launches the kernel; on CPU tensors it is
    :func:`varlen_flash_attention_plain`."""
    _fwd_kernel_check(q, k, v, cu_seqlens_q, cu_seqlens_k)
    tq, h, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((h, tq), dtype=torch.float32, device=q.device)
    order = _order_scratch(tq, q)
    status = L.library().ptt_varlen_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cu_seqlens_q.data_ptr(),
        cu_seqlens_k.data_ptr(), order.data_ptr(), out.data_ptr(),
        lse.data_ptr(), tq, tk,
        cu_seqlens_q.shape[0] - 1, h, hk, d, int(causal), window_size,
        sm_scale, _DTYPES[q.dtype], L.cuda_stream(q))
    name = ("varlen_flash_attention_f32" if q.dtype == torch.float32
            else "varlen_flash_attention")
    L.check_status(name, status)
    L.LAUNCHES[name] += 1
    return out, lse


_varlen_op = L.custom_op("varlen_flash_attention", _varlen_cuda)


@_varlen_op.register_kernel("cpu")
def _(q, k, v, cu_seqlens_q, cu_seqlens_k, causal, sm_scale, window_size):
    out, lse = varlen_flash_attention_plain(
        q, k, v, cu_seqlens_q, cu_seqlens_k, causal, sm_scale,
        window_size or None)
    return out.contiguous(), lse.contiguous()


@_varlen_op.register_fake
def _(q, k, v, cu_seqlens_q, cu_seqlens_k, causal, sm_scale, window_size):
    if q.device.type == "cuda":
        _fwd_kernel_check(q, k, v, cu_seqlens_q, cu_seqlens_k)
    tq, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((h, tq), dtype=torch.float32))


def varlen_flash_attention_bwd_delta(out, do):
    """``delta = rowsum(do * out)`` in f32, (H, total_q): the backward's
    per-row term (a torch op, as the reference computes it outside
    Pallas)."""
    return (do.float() * out.float()).sum(-1).t().contiguous()


def varlen_flash_attention_bwd_plain(q, k, v, out, lse, do, cu_seqlens_q,
                                     cu_seqlens_k, causal=False,
                                     sm_scale=None, window_size=None,
                                     delta=None):
    """Plain version of K8 (the reference's ``_varlen_bwd``):
    returns ``(dq, dk, dv)`` like q, k, v. P is recomputed from ``lse`` (H,
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


def _bwd_check(q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, causal,
               window_size):
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
    return tensors


def _bwd_launch_args(q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k,
                     causal, sm_scale, window_size):
    tensors = _bwd_check(q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k,
                         causal, window_size)
    tq, h, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
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


class VarlenBwdSchedule:
    """The fused varlen backward's work order
    (``csrc/varlen_flash_attention_bwd.cu``, whose bf16 and f32 kernels
    follow it formula for formula; the segment formulas are
    ``csrc/varlen_seg.cuh``'s), from the cu_seqlens on the host.

    A work item is one CTA's key tile: (key tile ``j`` of ``block_k``
    keys, KV head), ``halves`` warpgroups of 64 keys; ``block_k`` is 64 at
    head width ``d`` = 64 and 128 at d = 128 (``_bwd_block_k``). It walks
    the 64-row query tiles that hold a live pair with any half, highest
    first, and for
    each the query heads of its KV head's group in order; it sums dk and
    dv in registers and adds its dq partial of each (query head, query
    tile) into an f32 workspace. Order:

    - Items are claimed through one ticket counter in the order ``ticket
      = j * hk + kv_head``: key tiles ascending, heads interleaved.
    - The contributors of a query tile are the key tiles with a live pair
      with its rows (``runs_live``); in a packed batch a key tile inside
      the tile's key range may be dead (keys of a segment without
      queries, a window edge). Each (query head, query tile) takes its dq
      adds from them alone, in ascending key-tile order: the first stores
      into the workspace, the last adds the workspace to its own partial
      and writes dq in bf16 (the f32 kernel adds into dq itself, in the
      same order: the first stores, each later one adds). The tile's counter holds 1 + the key tile of
      the last add landed, and a contributor waits for ``prev``, the
      nearest contributor below it, found by scanning down from it inside
      the tile's ``key_range_of`` (``last``: none above it in the range).
    - ``prev`` is a lower key tile of the same KV head: an earlier ticket.
      Every claimed ticket belongs to a running CTA and the earliest
      unfinished one waits on nobody, so the waits cannot deadlock
      (``tests/test_torch_varlen_bwd_schedule.py`` simulates the grid).
    - A query tile with no contributor gets dq = 0 from the CTA whose
      ticket is its index modulo the grid.
    - A pair's mask is one interval test: key kj is seen by the queries
      ``key_queries(kj)``.
    """

    def __init__(self, cu_seqlens_q, cu_seqlens_k, tq, tk, h, hk, causal,
                 window=None, d=128):
        self.cu_q = [int(x) for x in cu_seqlens_q]
        self.cu_k = [int(x) for x in cu_seqlens_k]
        self.nseg = len(self.cu_q) - 1
        self.tq, self.tk, self.h, self.hk = tq, tk, h, hk
        self.causal, self.window = bool(causal), int(window or 0)
        self.group = h // hk
        self.block_q, self.block_k = _TILE, _bwd_block_k(d)
        self.halves = self.block_k // _TILE  # warpgroups of 64 keys
        # rows at or past cu_q[-1] and keys at or past cu_k[-1] are padding
        self.qend = min(tq, self.cu_q[-1])
        self.kend = min(tk, self.cu_k[-1])
        self.n_q = -(-tq // _TILE)
        self.n_k = -(-tk // self.block_k)
        self.n_items = self.n_k * hk
        self.n_counters = self.launch_sizes(tq, h, d)[1]

    # -- varlen_seg.cuh
    def _find_seg(self, cu, pos):
        lo, hi = 0, self.nseg - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if cu[mid] <= pos:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def _run_pairs(self, q_lo, q_hi, k_lo, k_hi, whole):
        """0 dead, 1 partial, 2 full (``run_pairs``)."""
        if q_lo > q_hi or k_lo > k_hi:
            return 0
        if not self.causal:
            return 2 if whole else 1
        w = self.window
        any_ = k_lo <= q_hi and (w <= 0 or k_hi > q_lo - w)
        all_ = whole and k_hi <= q_lo and (w <= 0 or k_lo > q_hi - w)
        return 0 if not any_ else 2 if all_ else 1

    def _query_row(self, qi):
        cu_q, cu_k = self.cu_q, self.cu_k
        if qi < self.tq and qi < cu_q[-1]:
            s = self._find_seg(cu_q, qi)
            return s, qi - cu_q[s] + (cu_k[s + 1] - cu_k[s]) \
                - (cu_q[s + 1] - cu_q[s])
        return -1, -(1 << 30)

    def _key_range_of(self, s_lo, first, s_hi, last):
        cu_k = self.cu_k
        lo, hi = cu_k[s_lo], cu_k[s_hi + 1]
        if self.causal:
            diag = cu_k[s_hi] + last + 1
            hi = min(hi, max(diag, cu_k[s_hi] if s_hi > s_lo else 0))
            if self.window:
                edge = cu_k[s_lo] + first - self.window + 1
                lo = max(lo, min(edge, cu_k[s_lo + 1]) if s_hi > s_lo
                         else edge)
        return lo, min(hi, self.tk)

    def _query_range_of(self, s_lo, first, s_hi, last):
        cu_q, cu_k = self.cu_q, self.cu_k
        lo, hi = cu_q[s_lo], cu_q[s_hi + 1]
        if self.causal:
            shift_lo = (cu_q[s_lo + 1] - cu_q[s_lo]) \
                - (cu_k[s_lo + 1] - cu_k[s_lo])
            start = cu_q[s_lo] + first + shift_lo
            lo = max(lo, min(start, cu_q[s_lo + 1]) if s_hi > s_lo
                     else start)
            if self.window:
                shift_hi = (cu_q[s_hi + 1] - cu_q[s_hi]) \
                    - (cu_k[s_hi + 1] - cu_k[s_hi])
                end = cu_q[s_hi] + last + self.window + shift_hi
                hi = min(hi, max(end, cu_q[s_hi]) if s_hi > s_lo else end)
        return lo, max(hi, lo)

    def _query_walk(self, kw):
        """``query_walk`` of the 64 keys from kw: ((one_seg, lo, hi, off,
        own0), query range)."""
        none = (False, 0, 0, 0, 0)
        last = min(kw + _TILE, self.kend) - 1
        if last < kw:
            return none, (0, 0)
        cu_q, cu_k = self.cu_q, self.cu_k
        sf, sl = self._find_seg(cu_k, kw), self._find_seg(cu_k, last)
        rng = self._query_range_of(sf, kw - cu_k[sf], sl, last - cu_k[sl])
        if sl != sf or last != kw + _TILE - 1:
            return none, rng
        return (True, cu_q[sf], min(cu_q[sf + 1], self.tq),
                cu_q[sf + 1] - (cu_k[sf + 1] - cu_k[sf]), kw - cu_k[sf]), rng

    def key_queries(self, kj):
        """[qa, qb): the queries that see key kj, the interval the kernel
        tests each pair's query position against (``key_queries``)."""
        if kj >= self.kend:
            return 0, 0
        cu_q, cu_k = self.cu_q, self.cu_k
        ks = self._find_seg(cu_k, kj)
        kr = kj - cu_k[ks]
        shift = (cu_k[ks + 1] - cu_k[ks]) - (cu_q[ks + 1] - cu_q[ks])
        a, b = cu_q[ks], min(cu_q[ks + 1], self.tq)
        if self.causal:
            a = max(a, cu_q[ks] + kr - shift)
            if self.window:
                b = min(b, cu_q[ks] + kr + self.window - shift)
        return a, max(a, b)

    def runs_live(self, q0, q1, k0, k1):
        """Whether a query of [q0, q1) and a key of [k0, k1) (bounded by
        the padding) form a live pair (``runs_live``)."""
        if q0 >= q1 or k0 >= k1:
            return False
        cu_q, cu_k = self.cu_q, self.cu_k
        s_hi = min(self._find_seg(cu_q, q1 - 1), self._find_seg(cu_k, k1 - 1))
        for s in range(max(self._find_seg(cu_q, q0),
                           self._find_seg(cu_k, k0)), s_hi + 1):
            qs, ks = cu_q[s], cu_k[s]
            shift = (cu_k[s + 1] - ks) - (cu_q[s + 1] - qs)
            if self._run_pairs(max(q0, qs) - qs + shift,
                               min(q1, cu_q[s + 1]) - 1 - qs + shift,
                               max(k0, ks) - ks,
                               min(k1, cu_k[s + 1]) - 1 - ks, False):
                return True
        return False

    # -- the kernel's walk and order
    def ticket(self, j, kv_head):
        return j * self.hk + kv_head

    def item(self, ticket):
        """(key tile, KV head) of a ticket."""
        return divmod(ticket, self.hk)

    def half_state(self, j, w, q0):
        """0 / 1 / 2: no, some or every pair of the query tile at q0 and
        half w of key tile j is live."""
        kw = j * self.block_k + w * _TILE
        (one_seg, lo, hi, off, own0), _ = self._query_walk(kw)
        if one_seg:
            return self._run_pairs(max(q0, lo) - off,
                                   min(q0 + _TILE, hi) - 1 - off, own0,
                                   own0 + _TILE - 1,
                                   q0 >= lo and q0 + _TILE <= hi)
        return int(self.runs_live(q0, min(q0 + _TILE, self.qend), kw,
                                  min(kw + _TILE, self.kend)))

    def tiles(self, j):
        """Key tile j's walk over query tiles, highest first: (i, state of
        half 0, state of half 1) of each tile with a live pair."""
        ranges = [self._query_walk(j * self.block_k + w * _TILE)[1]
                  for w in range(self.halves)]
        ranges = [r for r in ranges if r[0] < r[1]]
        if not ranges:
            return []
        lo = min(r[0] for r in ranges)
        hi = min(max(r[1] for r in ranges), self.qend)
        if hi <= lo:
            return []
        out = []
        for i in range((hi - 1) // _TILE, lo // _TILE - 1, -1):
            st = tuple(self.half_state(j, w, i * _TILE) if w < self.halves
                       else 0 for w in (0, 1))
            if any(st):
                out.append((i, *st))
        return out

    def walk(self, j):
        """The steps of key tile j's CTA: (query tile, query head of the
        group)."""
        return [(i, g) for i, _, _ in self.tiles(j)
                for g in range(self.group)]

    def _live(self, i, j):
        q0 = i * _TILE
        bk = self.block_k
        return self.runs_live(q0, min(q0 + _TILE, self.qend), j * bk,
                              min(j * bk + bk, self.kend))

    def key_range(self, i):
        """[klo, khi): the keys query tile i's rows can see
        (``key_range_of`` of its first and last real row)."""
        q0 = i * _TILE
        q1 = min(q0 + _TILE, self.qend)
        sf, rf = self._query_row(q0)
        sl, rl = self._query_row(q1 - 1)
        lo, hi = self._key_range_of(sf, rf, sl, rl)
        return lo, min(hi, self.kend)

    def order(self, i, j):
        """(prev, last) of key tile j in live query tile i's adds: the
        nearest contributor below j (-1 when j is the first), and whether
        none lies above it."""
        klo, khi = self.key_range(i)
        bk = self.block_k
        prev = next((jj for jj in range(j - 1, klo // bk - 1, -1)
                     if self._live(i, jj)), -1)
        last = not any(self._live(i, jj) for jj in range(j + 1, self.n_k)
                       if jj * bk < khi)
        return prev, last

    def contributors(self, i):
        """The key tiles that add to query tile i, ascending."""
        return [j for j in range(self.n_k) if self._live(i, j)]

    def rank(self, i, j):
        """(rank, contributors) of key tile j in query tile i's adds:
        ranks count the live contributors only."""
        c = self.contributors(i)
        return c.index(j), len(c)

    def zero_tiles(self):
        """The query tiles no key tile adds to, whose dq the kernel
        zeroes (padding rows, rows that see no key)."""
        return [i for i in range(self.n_q)
                if not self.runs_live(i * _TILE, min(i * _TILE + _TILE,
                                                     self.qend), 0,
                                      self.kend)]

    def counter(self, head, i):
        return 1 + head * self.n_q + i

    @staticmethod
    def launch_sizes(tq, h, d):
        """The f32 dq workspace's shape and the number of int32 counters,
        from the shapes alone (the launch takes them without reading
        cu_seqlens on the host). The workspace holds one contiguous
        (64, d + 4) tile per (head, query tile), sent as one bulk copy or
        reduce-add; 4 f32 of row padding keep the kernel's staging rows off
        one shared-memory bank. The counters are the ticket counter, then
        one per (head, query tile)."""
        n_q = -(-tq // _TILE)
        return (h, n_q, _TILE, d + 4), 1 + h * n_q

    def workspace_shape(self, d):
        return self.launch_sizes(self.tq, self.h, d)[0]


def _varlen_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, cu_seqlens_q: torch.Tensor,
                     cu_seqlens_k: torch.Tensor, causal: bool,
                     sm_scale: float,
                     window_size: int) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """K8 as a custom op: ``(dq, dk, dv)`` (``window_size`` 0: no
    window). On CUDA tensors it launches the fused kernel; on CPU tensors
    it is :func:`varlen_flash_attention_bwd_plain`."""
    window_size = window_size or None
    ptrs, dims = _bwd_launch_args(q, k, v, do, lse, delta, cu_seqlens_q,
                                  cu_seqlens_k, causal, sm_scale, window_size)
    tq, tk, h, d = q.shape[0], k.shape[0], q.shape[1], q.shape[2]
    if tq == 0 or tk == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    f32 = q.dtype == torch.float32
    ws_shape, n_counters = VarlenBwdSchedule.launch_sizes(tq, h, d)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # the f32 kernel adds into dq itself: no workspace
    ws = None if f32 else torch.empty(ws_shape, dtype=torch.float32,
                                      device=q.device)
    counters = torch.zeros(n_counters, dtype=torch.int32, device=q.device)
    name = ("varlen_flash_attention_bwd_f32" if f32
            else "varlen_flash_attention_bwd")
    status = L.library().ptt_varlen_flash_attention_bwd_fused(
        *ptrs, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if ws is None else ws.data_ptr(), counters.data_ptr(), *dims)
    L.check_status(name, status)
    L.LAUNCHES[name] += 1
    return dq, dk, dv


_varlen_bwd_op = L.custom_op("varlen_flash_attention_bwd", _varlen_bwd_cuda)


@_varlen_bwd_op.register_kernel("cpu")
def _(q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, causal, sm_scale,
      window_size):
    return tuple(t.contiguous() for t in varlen_flash_attention_bwd_plain(
        q, k, v, None, lse, do, cu_seqlens_q, cu_seqlens_k, causal,
        sm_scale, window_size or None, delta))


@_varlen_bwd_op.register_fake
def _(q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, causal, sm_scale,
      window_size):
    if q.device.type == "cuda":
        _bwd_check(q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k,
                   causal, window_size or None)
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def varlen_flash_attention_bwd_fused(q, k, v, do, lse, delta, cu_seqlens_q,
                                     cu_seqlens_k, causal=False,
                                     sm_scale=None, window_size=None):
    """K8: ``(dq, dk, dv)`` in one launch of the fused backward kernel,
    from the forward's ``lse`` and ``delta``
    (:func:`varlen_flash_attention_bwd_delta`); dk and dv are each KV
    head's sum over the query heads of its group. CPU tensors run the
    plain backward; CUDA tensors launch the bf16 kernel (counted as
    ``varlen_flash_attention_bwd``) or the f32 one
    (``varlen_flash_attention_bwd_f32``)."""
    how = L.route(q, k, v, do)
    if how == "plain":
        return varlen_flash_attention_bwd_plain(
            q, k, v, None, lse, do, cu_seqlens_q, cu_seqlens_k, causal,
            sm_scale, window_size, delta)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    fn = (_varlen_bwd_cuda if how == "kernel"
          else torch.ops.paddle_tpu_torch.varlen_flash_attention_bwd.default)
    return fn(q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k,
              bool(causal), float(sm_scale), int(window_size or 0))


def varlen_flash_attention_bwd_dq(q, k, v, do, lse, delta, cu_seqlens_q,
                                  cu_seqlens_k, causal=False, sm_scale=None,
                                  window_size=None):
    """dq (like q) from the forward's ``lse`` and ``delta``
    (:func:`varlen_flash_attention_bwd_delta`). CPU tensors run the plain
    backward; CUDA tensors launch the fused K8 (which also computes dk and
    dv) or raise."""
    if L.route(q, k, v, do) == "plain":
        return varlen_flash_attention_bwd_plain(
            q, k, v, None, lse, do, cu_seqlens_q, cu_seqlens_k, causal,
            sm_scale, window_size, delta)[0]
    return varlen_flash_attention_bwd_fused(
        q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, causal,
        sm_scale, window_size)[0]


def varlen_flash_attention_bwd_dkv(q, k, v, do, lse, delta, cu_seqlens_q,
                                   cu_seqlens_k, causal=False, sm_scale=None,
                                   window_size=None):
    """``(dk, dv)`` (like k, v), each KV head's sum over the query heads
    of its group. CPU tensors run the plain backward; CUDA tensors launch
    the fused K8 or raise."""
    if L.route(q, k, v, do) == "plain":
        return varlen_flash_attention_bwd_plain(
            q, k, v, None, lse, do, cu_seqlens_q, cu_seqlens_k, causal,
            sm_scale, window_size, delta)[1:]
    return varlen_flash_attention_bwd_fused(
        q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, causal,
        sm_scale, window_size)[1:]


def varlen_flash_attention_bwd(q, k, v, out, lse, do, cu_seqlens_q,
                               cu_seqlens_k, causal=False, sm_scale=None,
                               window_size=None):
    """Gradients ``(dq, dk, dv)`` of varlen attention from the forward's
    ``out`` and ``lse`` and the upstream ``do`` (like q): delta, then on
    CUDA tensors one launch of the fused K8 (bf16 or f32);
    :func:`varlen_flash_attention_bwd_plain` on CPU tensors."""
    if out.shape != q.shape:
        raise ValueError(f"varlen_flash_attention_bwd: out "
                         f"{tuple(out.shape)} for q {tuple(q.shape)}")
    if L.route(q, k, v, do) == "plain":
        return varlen_flash_attention_bwd_plain(
            q, k, v, out, lse, do, cu_seqlens_q, cu_seqlens_k, causal,
            sm_scale, window_size)
    delta = varlen_flash_attention_bwd_delta(out, do)
    args = (q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, causal,
            sm_scale, window_size)
    return varlen_flash_attention_bwd_fused(*args)


class VarlenFlashAttentionFunction(torch.autograd.Function):
    """``out = varlen_flash_attention(q, k, v, cu_seqlens_q, cu_seqlens_k,
    causal, sm_scale, window_size)`` with K8 as its backward (the
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
