"""Dense flash attention forward: the Hopper kernel K4 and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py`` (forward; the
backward kernels belong to the training slice). Paddle layout: q
(B, Sq, H, D), k/v (B, Sk, HK, D), H a multiple of HK. Causal masks are
bottom-right aligned (``k <= q + Sk - Sq``), keys past ``Sk`` never count,
and ``window_size`` (with ``causal``) keeps the last ``window_size`` keys
of each query, itself included (Mistral semantics). A row that sees no
key returns zeros. Scores and softmax statistics are f32; the
probabilities are rounded to v's dtype before the product with v, as the
TPU kernel does. The CUDA source is
``paddle_tpu_torch/csrc/flash_attention.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _library as L

__all__ = ["flash_attention", "flash_attention_plain", "band_mask"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


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


def flash_attention(q, k, v, causal=False, sm_scale=None, window_size=None,
                    return_lse=False):
    """Flash attention over paddle layout (B, S, H, D).

    CPU tensors run :func:`flash_attention_plain`; CUDA tensors launch
    the kernel or raise. With ``return_lse`` also returns the (B, H, Sq)
    f32 log-sum-exp the kernel writes (the backward's residual)."""
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
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if L.use_plain(q):
        out, lse = flash_attention_plain(q, k, v, causal, sm_scale,
                                         window_size)
        return (out, lse) if return_lse else out
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q, k, v of "
            f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention: inputs lie on different "
                             "devices")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    status = L.library().ptt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, h, hk, d, int(bool(causal)),
        int(window_size or 0), float(sm_scale), _DTYPES[q.dtype],
        L.cuda_stream(q))
    L.check_status("flash_attention", status)
    L.LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out
