"""Dense flash attention, forward and backward: the Hopper kernels K4
(forward) and K7 (the backward: one fused kernel for dq, dk and dv, on
wgmma in bf16 and as 3xTF32 in f32), their plain PyTorch versions, and the
autograd Function that joins them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``. Paddle
layout: q (B, Sq, H, D), k/v (B, Sk, HK, D), H a multiple of HK. Causal
masks are bottom-right aligned (``k <= q + Sk - Sq``), keys past ``Sk``
never count, and ``window_size`` (with ``causal``) keeps the last
``window_size`` keys of each query, itself included (Mistral semantics). A
row that sees no key returns zeros. Scores and softmax statistics are f32;
the probabilities are rounded to v's dtype before the product with v, as
the TPU kernel does. The backward recomputes P from the forward's
log-sum-exp with the TPU kernel's roundings (see
:func:`flash_attention_bwd_plain`). :class:`FwdTiles` states the bf16
forward kernel's tile plan and launch order, :class:`BwdSchedule` the fused
backward's work order and dq add order (:func:`bwd_block_k` its key tile);
the kernels follow them.
:class:`FlashAttentionFunction` mirrors
the reference's ``custom_vjp``. The CUDA sources are
``paddle_tpu_torch/csrc/flash_attention.cu`` and
``paddle_tpu_torch/csrc/flash_attention_bwd.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _library as L

__all__ = ["flash_attention", "flash_attention_plain", "band_mask",
           "flash_attention_bwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bwd_fused",
           "flash_attention_bwd_delta",
           "flash_attention_bwd_plain", "FlashAttentionFunction",
           "FwdTiles", "BwdSchedule", "bwd_block_k"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# the bf16 forward's tiles (flash_attention.cu kTQ, kTK): 128 query rows
# per CTA, 128 keys per tile
FWD_BLOCK_Q = 128
FWD_BLOCK_K = 128
# the fused backward's tiles (flash_attention_bwd.cu): 64 query rows of a
# dq tile (flash_mma.cuh kBQ), 128 keys per CTA (kFBK; the f32 kernel's
# bwd_f32.cuh Shape: 64 at head width 64)
BWD_BLOCK_Q = 64
BWD_BLOCK_K = 128


def bwd_block_k(dtype, d):
    """Keys per CTA of the fused backward: 128, but 64 for the f32 kernel
    at head width 64 (three 64-key CTAs share an SM)."""
    return 64 if dtype == torch.float32 and d == 64 else BWD_BLOCK_K


def band_mask(sq, sk, causal, window=None, device=None):
    """(Sq, Sk) bool mask of live (query, key) pairs: bottom-right causal
    and the sliding-window band."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q, k, v, causal=False, sm_scale=None,
                          window_size=None):
    """Plain version of K4: one masked softmax in f32, P rounded to v's
    dtype before P.V. Returns ``(out, lse)``: out like q, lse (B, H, Sq)
    f32 (``m + log(l)``; about -1e30 for a row with no live key)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    g = h // hk
    mask = band_mask(sq, sk, causal, window_size, q.device)
    qf = q.float().reshape(b, sq, hk, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * sm_scale
    s = s.masked_fill(~mask, NEG_INF)
    m = (s.amax(dim=-1, keepdim=True) if sk
         else torch.full(s.shape[:-1] + (1,), NEG_INF, device=q.device))
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                       v.float()) / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l))[..., 0].reshape(b, h, sq)
    return out.reshape(b, sq, h, d).to(q.dtype), lse


def _check_args(q, k, v, causal, window_size):
    """Validate the layout; returns (b, sq, sk, h, hk, d)."""
    if window_size is not None:
        if not causal:
            raise ValueError(
                "window_size requires causal=True (a non-causal window is "
                "ambiguous about its anchor)")
        if window_size < 1:
            raise ValueError(f"window_size must be >= 1, got {window_size}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if h % hk != 0:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({hk})")
    return b, sq, sk, h, hk, d


def flash_attention(q, k, v, causal=False, sm_scale=None, window_size=None,
                    return_lse=False):
    """Flash attention over paddle layout (B, S, H, D).

    CPU tensors run :func:`flash_attention_plain`; CUDA tensors launch
    the kernel or raise. With ``return_lse`` also returns the (B, H, Sq)
    f32 log-sum-exp the kernel writes (the backward's residual). The
    result carries no autograd history on the kernel path: differentiate
    through :class:`FlashAttentionFunction`."""
    b, sq, sk, h, hk, d = _check_args(q, k, v, causal, window_size)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if L.use_plain(q):
        out, lse = flash_attention_plain(q, k, v, causal, sm_scale,
                                         window_size)
        return (out, lse) if return_lse else out
    _check_kernel_inputs("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    status = L.library().ptt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, h, hk, d, int(bool(causal)),
        int(window_size or 0), float(sm_scale), _DTYPES[q.dtype],
        L.cuda_stream(q))
    name = ("flash_attention_f32" if q.dtype == torch.float32
            else "flash_attention")
    L.check_status(name, status)
    L.LAUNCHES[name] += 1
    return (out, lse) if return_lse else out


def _check_kernel_inputs(name, q, *others):
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in others):
        raise TypeError(
            f"{name} kernel takes float32 or bfloat16 inputs of one dtype, "
            f"got {[t.dtype for t in (q, *others)]}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise NotImplementedError(
            f"{name} kernel takes head_dim in {_HEAD_DIMS}, got "
            f"{q.shape[-1]}")
    if any(t.device != q.device for t in others):
        raise ValueError(f"{name}: inputs lie on different devices")
    if not all(t.is_contiguous() for t in (q, *others)):
        raise ValueError(f"{name} kernel needs contiguous inputs")


def flash_attention_bwd_delta(out, do):
    """``delta = rowsum(do * out)`` in f32, (B, H, Sq): the backward's
    per-row term (a torch op, as the reference computes it outside
    Pallas)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False,
                              sm_scale=None, window_size=None, delta=None):
    """Plain version of K7 (the reference's ``_flash_bwd``): returns
    ``(dq, dk, dv)`` like q, k, v. P is recomputed from ``lse`` in f32 and
    ``delta`` (default from ``out``) is f32; P is rounded to do's dtype
    before dV, dS to k's dtype before dQ and to q's dtype before dK;
    products accumulate in f32. A GQA group's query heads are summed into
    their KV head's dk and dv in f32 before the one rounding to the input
    dtype."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if delta is None:
        delta = flash_attention_bwd_delta(out, do)
    g = h // hk
    mask = band_mask(sq, sk, causal, window_size, q.device)
    qf = q.float().reshape(b, sq, hk, g, d)
    dof = do.float().reshape(b, sq, hk, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * sm_scale
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hk, g, sq, 1)), 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta.reshape(b, hk, g, sq, 1)) * sm_scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(do.dtype).float(), dof)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds.to(q.dtype).float(), qf)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FwdTiles:
    """The bf16 forward kernel's tile plan (``csrc/flash_attention.cu``,
    which follows it formula for formula).

    One CTA per (query tile ``i`` of ``block_q`` rows, batch, head). Its
    rows see one contiguous key range ``[lo, hi)``: the window edge of its
    first row to the causal diagonal of its last row (``_kv_band_clamp``;
    all of ``[0, sk)`` without ``causal``). It walks that range from
    ``lo`` in tiles of ``block_k`` keys, so no tile without a live pair is
    read, and masks only the boundary tiles: a "full" tile is all live
    for every real row. The grid is 1-D. Rank ``r`` of the launch order
    takes the query tiles by their live keys, most first, ties to the
    higher tile; within a rank the (batch, head) pairs follow with the
    heads fastest, so the query heads of one KV head run side by side.
    """

    block_q, block_k = FWD_BLOCK_Q, FWD_BLOCK_K

    def __init__(self, b, sq, sk, h, hk, causal, window=None):
        self.b, self.sq, self.sk, self.h, self.hk = b, sq, sk, h, hk
        self.causal, self.window = bool(causal), int(window or 0)
        self.off = sk - sq  # bottom-right causal alignment
        self.n_q = -(-sq // self.block_q)
        self.n_items = self.n_q * b * h

    def key_range(self, i):
        """``(lo, hi)`` of query tile ``i`` (flash_mma.cuh ``key_range``);
        no key when ``hi <= lo``."""
        q0 = i * self.block_q
        lo, hi = 0, self.sk
        if self.causal:
            hi = min(hi, min(q0 + self.block_q, self.sq) - 1 + self.off + 1)
            if self.window:
                lo = max(0, q0 + self.off - self.window + 1)
        return lo, hi

    def live_keys(self, i):
        lo, hi = self.key_range(i)
        return max(hi - lo, 0)

    def tiles(self, i):
        """The first keys of the key tiles query tile ``i`` walks."""
        lo, hi = self.key_range(i)
        return list(range(lo, hi, self.block_k)) if hi > lo else []

    def full(self, i, k0):
        """Every pair of query tile ``i`` and the key tile at ``k0`` is
        live for every row below ``sq`` (flash_mma.cuh ``full_tile``): the
        kernel skips the mask."""
        if k0 + self.block_k > self.sk:
            return False
        if not self.causal:
            return True
        q0 = i * self.block_q
        if k0 + self.block_k - 1 > q0 + self.off:
            return False
        q_last = min(q0 + self.block_q, self.sq) - 1
        return not self.window or k0 > q_last + self.off - self.window

    def tile_of_rank(self, r):
        """The query tile of rank ``r``. Below the last tile the live keys
        never fall as the tile rises, so the order is the tiles from the
        top down with the last (ragged) one placed behind the tiles that
        see more keys than it does."""
        n = self.n_q
        last = self.live_keys(n - 1)
        p = 0
        while p < n - 1 and self.live_keys(n - 2 - p) > last:
            p += 1
        return n - 2 - r if r < p else (n - 1 if r == p else n - 1 - r)

    def item(self, w):
        """``(query tile, batch, head)`` of CTA ``w`` (``blockIdx.x``)."""
        r, bh = divmod(w, self.b * self.h)
        return self.tile_of_rank(r), bh // self.h, bh % self.h

    def order(self):
        return [self.item(w) for w in range(self.n_items)]


class BwdSchedule:
    """The fused backward's work order (``csrc/flash_attention_bwd.cu``,
    whose bf16 and f32 kernels follow it formula for formula, each at its
    own ``block_k``: :func:`bwd_block_k`).

    A work item is one CTA's key tile: (batch, KV head, key tile ``j`` of
    ``block_k`` keys). It walks the query tiles (``block_q`` rows) that hold
    a live pair with its keys, highest first, and for each tile the query
    heads of its KV head's group in order; it sums dk and dv in registers
    and adds its dq partial of each (query head, query tile) into an f32
    workspace. Order:

    - Items are claimed through one ticket counter in the order
      ``ticket = (j * b + batch) * hk + kv_head``: key tiles ascending,
      heads interleaved. Under causal masking low key tiles walk the most
      query tiles, so the long items start first and the grid ends on
      short ones.
    - Each (batch, query head, query tile) receives its dq partials in
      ascending key-tile order, ``rank = j - jlo``: the first (``rank``
      0) stores into the workspace, the last (``j == jhi``) adds the
      workspace to its own partial and writes dq in bf16; a tile with one
      contributor writes dq straight away. The f32 kernel adds into dq
      itself in the same order: rank 0 stores, each later rank adds.
    - A contributor waits only on the one before it, a lower key tile of
      the same batch and KV head: an earlier ticket. Every claimed ticket
      belongs to a running CTA and the earliest unfinished one waits on
      nobody, so the waits cannot deadlock. Under causal masking every
      key tile's walk starts at the last query tile, and key tile j - 1
      reaches each tile before key tile j whenever it started at least
      one step earlier, as it does after the first wave: so after the
      first wave no CTA waits (``tests/test_torch_flash_bwd_schedule.py``
      simulates it).
    """

    def __init__(self, b, sq, sk, h, hk, causal, window=None,
                 block_q=BWD_BLOCK_Q, block_k=BWD_BLOCK_K):
        self.b, self.sq, self.sk, self.h, self.hk = b, sq, sk, h, hk
        self.causal, self.window = bool(causal), int(window or 0)
        self.block_q, self.block_k = block_q, block_k
        self.off = sk - sq  # bottom-right causal alignment
        self.group = h // hk
        self.n_q = -(-sq // block_q)
        self.n_k = -(-sk // block_k)
        self.n_items = self.n_k * b * hk
        # the ticket counter, then one per (batch, head, query tile)
        self.n_counters = 1 + b * h * self.n_q

    def item(self, ticket):
        """(key tile, batch, KV head) of a ticket."""
        j, r = divmod(ticket, self.b * self.hk)
        return j, r // self.hk, r % self.hk

    def ticket(self, j, batch, kv_head):
        return (j * self.b + batch) * self.hk + kv_head

    def key_tiles(self, i):
        """(jlo, jhi), the key tiles holding a live pair with query tile
        ``i`` (flash_mma.cuh ``key_range``), or None."""
        q0 = i * self.block_q
        lo, hi = 0, self.sk
        if self.causal:
            hi = min(hi, min(q0 + self.block_q, self.sq) - 1 + self.off + 1)
            if self.window:
                lo = max(0, q0 + self.off - self.window + 1)
        if hi <= lo:
            return None
        return lo // self.block_k, (hi - 1) // self.block_k

    def query_tiles(self, j):
        """(ilo, ihi), the query tiles holding a live pair with key tile
        ``j`` (the kernel's ``query_range``), or None."""
        k0 = j * self.block_k
        lo, hi = 0, self.sq
        if self.causal:
            lo = max(0, k0 - self.off)
            if self.window:
                hi = min(hi, min(k0 + self.block_k, self.sk) - 1 - self.off
                         + self.window)
        if hi <= lo:
            return None
        return lo // self.block_q, (hi - 1) // self.block_q

    def walk(self, j):
        """The steps of key tile ``j``'s CTA: (query tile, query head of
        the group), tiles from the highest down."""
        tiles = self.query_tiles(j)
        if tiles is None:
            return []
        return [(i, g) for i in range(tiles[1], tiles[0] - 1, -1)
                for g in range(self.group)]

    def rank(self, i, j):
        """(rank, contributors) of key tile ``j`` in query tile ``i``'s
        add order."""
        jlo, jhi = self.key_tiles(i)
        return j - jlo, jhi - jlo + 1

    def counter(self, batch, head, i):
        return 1 + (batch * self.h + head) * self.n_q + i

    def workspace_shape(self, d):
        """The f32 dq workspace: one contiguous (block_q, d + 4) tile per
        (batch, head, query tile), sent as one bulk copy or reduce-add; 4
        f32 of row padding keep the kernel's staging rows off one
        shared-memory bank."""
        return (self.b, self.h, self.n_q, self.block_q, d + 4)


def _bwd_launch_args(q, k, v, do, lse, delta, causal, sm_scale,
                     window_size):
    b, sq, sk, h, hk, d = _check_args(q, k, v, causal, window_size)
    if do.shape != q.shape or lse.shape != (b, h, sq) \
            or delta.shape != (b, h, sq):
        raise ValueError(
            f"flash_attention backward: do {tuple(do.shape)}, lse "
            f"{tuple(lse.shape)}, delta {tuple(delta.shape)} for q "
            f"{tuple(q.shape)}")
    _check_kernel_inputs("flash_attention backward", q, k, v, do)
    for t in (lse, delta):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise TypeError("flash_attention backward kernels take "
                            "contiguous f32 lse and delta on q's device")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr()), (
        b, sq, sk, h, hk, d, int(bool(causal)), int(window_size or 0),
        float(sm_scale), _DTYPES[q.dtype], L.cuda_stream(q))


def flash_attention_bwd_fused(q, k, v, do, lse, delta, causal=False,
                              sm_scale=None, window_size=None):
    """K7: ``(dq, dk, dv)`` in one launch of the fused backward kernel,
    from the forward's ``lse`` and ``delta``
    (:func:`flash_attention_bwd_delta`); dk and dv are each KV head's sum
    over the query heads of its group. CPU tensors run the plain
    backward; CUDA tensors launch the bf16 kernel (counted as
    ``flash_attention_bwd``) or the f32 one (``flash_attention_bwd_f32``)."""
    if L.use_plain(q):
        return flash_attention_bwd_plain(q, k, v, None, lse, do, causal,
                                         sm_scale, window_size, delta)
    ptrs, dims = _bwd_launch_args(q, k, v, do, lse, delta, causal, sm_scale,
                                  window_size)
    b, sq, sk, h, hk, d = dims[:6]
    f32 = q.dtype == torch.float32
    sched = BwdSchedule(b, sq, sk, h, hk, causal, window_size,
                        block_k=bwd_block_k(q.dtype, d))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if sk == 0:
        return torch.zeros_like(q), dk, dv
    dq = torch.empty_like(q)
    if causal and sq > sk:
        # rows that see no key: their tiles may have no contributor
        dq[:, :sq - sk].zero_()
    # the f32 kernel adds into dq itself: no workspace
    ws = None if f32 else torch.empty(sched.workspace_shape(d),
                                      dtype=torch.float32, device=q.device)
    counters = torch.zeros(sched.n_counters, dtype=torch.int32,
                           device=q.device)
    name = "flash_attention_bwd_f32" if f32 else "flash_attention_bwd"
    status = L.library().ptt_flash_attention_bwd_fused(
        *ptrs, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if ws is None else ws.data_ptr(), counters.data_ptr(), *dims)
    L.check_status(name, status)
    L.LAUNCHES[name] += 1
    return dq, dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           sm_scale=None, window_size=None):
    """dq (like q) from the forward's ``lse`` and ``delta``
    (:func:`flash_attention_bwd_delta`). CPU tensors run the plain
    backward; CUDA tensors launch the fused K7 (which also computes dk
    and dv) or raise."""
    if L.use_plain(q):
        return flash_attention_bwd_plain(q, k, v, None, lse, do, causal,
                                         sm_scale, window_size, delta)[0]
    return flash_attention_bwd_fused(q, k, v, do, lse, delta, causal,
                                     sm_scale, window_size)[0]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            sm_scale=None, window_size=None):
    """``(dk, dv)`` (like k, v), each KV head's sum over the query heads
    of its group. CPU tensors run the plain backward; CUDA tensors launch
    the fused K7 or raise."""
    if L.use_plain(q):
        return flash_attention_bwd_plain(q, k, v, None, lse, do, causal,
                                         sm_scale, window_size, delta)[1:]
    return flash_attention_bwd_fused(q, k, v, do, lse, delta, causal,
                                     sm_scale, window_size)[1:]


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, sm_scale=None,
                        window_size=None):
    """Gradients ``(dq, dk, dv)`` of flash attention from the forward's
    ``out`` and ``lse`` and the upstream ``do`` (like q): delta, then on
    CUDA tensors one launch of the fused K7 (bf16 or f32);
    :func:`flash_attention_bwd_plain` on CPU tensors."""
    if out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} for "
                         f"q {tuple(q.shape)}")
    if L.use_plain(q):
        _check_args(q, k, v, causal, window_size)
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         sm_scale, window_size)
    delta = flash_attention_bwd_delta(out, do)
    return flash_attention_bwd_fused(q, k, v, do, lse, delta, causal,
                                     sm_scale, window_size)


class FlashAttentionFunction(torch.autograd.Function):
    """``out = flash_attention(q, k, v, causal, sm_scale, window_size)``
    with K7 as its backward (the reference's
    ``_flash_attention_bhsd`` custom_vjp: the forward keeps q, k, v, out
    and lse, the backward recomputes P from lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, sm_scale=None, window_size=None):
        out, lse = flash_attention(q, k, v, causal, sm_scale, window_size,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, window_size)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do.contiguous().to(q.dtype), *ctx.args)
        return dq, dk, dv, None, None, None
