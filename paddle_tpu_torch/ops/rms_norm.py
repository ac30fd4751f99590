"""RMSNorm forward and backward: the Hopper kernels K1 and K6, their plain
PyTorch versions, and the autograd Function that joins them.

Counterpart of ``paddle_tpu/ops/pallas/rms_norm.py``. Rows are all leading
dims flattened; the last axis is normalized. Math in f32:

    r  = rsqrt(mean(x^2) + eps)        y  = x * r * w
    g  = dy * w                        dx = g * r - x * r^3 * mean(g * x)
    dw = sum_rows(dy * x * r)

:class:`RMSNormFunction` mirrors the reference's ``custom_vjp``: the
forward saves x, w and the per-row r, the backward is K6 (its plain
version on CPU tensors). The CUDA source of both kernels is
``paddle_tpu_torch/csrc/rms_norm.cu``.
"""
from __future__ import annotations

import torch

from . import _library as L

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
           "RMSNormFunction"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K6 splits the rows into at most this many contiguous blocks (4 per SM of
# an H100), one CTA each, each writing one f32 row of dw partial sums
_BWD_MAX_BLOCKS = 528


def rms_norm_plain(x, weight, epsilon=1e-6):
    """Plain version of K1: returns ``(y, rstd)``, ``rstd`` shaped
    ``x.shape[:-1]`` in f32."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    y = (xf * r * weight.float()).to(x.dtype)
    return y, r.squeeze(-1)


def _check(x, weight):
    if weight.dim() != 1 or x.shape[-1] != weight.shape[0]:
        raise ValueError(
            f"rms_norm: weight {tuple(weight.shape)} does not match the last "
            f"axis of x {tuple(x.shape)}")


def _check_kernel_inputs(name, x, weight, *others):
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(
            f"{name} kernel takes float32 or bfloat16 x with a weight of "
            f"the same dtype, got {x.dtype} and {weight.dtype}")
    if any(t.device != x.device for t in (weight, *others)):
        raise ValueError(f"{name}: inputs lie on different devices")
    if not all(t.is_contiguous() for t in (x, weight, *others)):
        raise ValueError(f"{name} kernel needs contiguous inputs")


def rms_norm(x, weight, epsilon=1e-6, return_rstd=False):
    """RMSNorm over the last axis; ``x`` (..., N), ``weight`` (N,).

    CPU tensors run :func:`rms_norm_plain`; CUDA tensors launch the
    kernel, or raise on a dtype, shape or layout it does not take. With
    ``return_rstd`` also returns the per-row ``rsqrt(mean(x^2) + eps)``
    that the backward takes. The result carries no autograd history on
    the kernel path: differentiate through :class:`RMSNormFunction`."""
    _check(x, weight)
    if L.use_plain(x):
        y, r = rms_norm_plain(x, weight, epsilon)
        return (y, r) if return_rstd else y
    _check_kernel_inputs("rms_norm", x, weight)
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    y = torch.empty_like(x)
    r = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
         if return_rstd else None)
    lib = L.library()
    status = lib.ptt_rms_norm(
        x.data_ptr(), weight.data_ptr(), y.data_ptr(),
        r.data_ptr() if r is not None else None, rows, n, float(epsilon),
        _DTYPES[x.dtype], L.cuda_stream(x))
    L.check_status("rms_norm", status)
    L.LAUNCHES["rms_norm"] += 1
    return (y, r) if return_rstd else y


def rms_norm_bwd_plain(x, weight, rstd, dy):
    """Plain version of K6 (the reference's ``_bwd_kernel``) in f32:
    returns ``(dx, dw)``, dx in x's dtype, dw summed over every row in
    f32 and cast to the weight's dtype."""
    n = x.shape[-1]
    xf, dyf = x.float().reshape(-1, n), dy.float().reshape(-1, n)
    r = rstd.float().reshape(-1, 1)
    g = dyf * weight.float()
    mean_gx = (g * xf).mean(dim=-1, keepdim=True)
    dx = g * r - xf * (r * r * r) * mean_gx
    dw = (dyf * xf * r).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype)


def rms_norm_bwd(x, weight, rstd, dy):
    """RMSNorm backward: ``(dx, dw)`` from x (..., N), weight (N,), the
    forward's ``rstd`` (x.shape[:-1], f32) and the upstream ``dy`` (like
    x). CPU tensors run :func:`rms_norm_bwd_plain`; CUDA tensors launch
    K6 (a row pass writing dx and per-CTA dw partials, then a fixed-order
    reduction of the partials: deterministic, no atomics) or raise."""
    _check(x, weight)
    if dy.shape != x.shape or rstd.shape != x.shape[:-1]:
        raise ValueError(
            f"rms_norm_bwd: dy {tuple(dy.shape)} and rstd "
            f"{tuple(rstd.shape)} do not match x {tuple(x.shape)}")
    if L.use_plain(x):
        return rms_norm_bwd_plain(x, weight, rstd, dy)
    _check_kernel_inputs("rms_norm_bwd", x, weight, dy, rstd)
    if dy.dtype != x.dtype or rstd.dtype != torch.float32:
        raise TypeError(
            f"rms_norm_bwd kernel takes dy in x's dtype and f32 rstd, got "
            f"{dy.dtype} and {rstd.dtype}")
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    if rows == 0:
        return dx, dw.zero_()
    nblk = min(rows, _BWD_MAX_BLOCKS)
    part = torch.empty((nblk, n), dtype=torch.float32, device=x.device)
    status = L.library().ptt_rms_norm_bwd(
        x.data_ptr(), weight.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dw.data_ptr(), rows, n, nblk,
        _DTYPES[x.dtype], L.cuda_stream(x))
    L.check_status("rms_norm_bwd", status)
    L.LAUNCHES["rms_norm_bwd"] += 1
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """``y = rms_norm(x, weight, epsilon)`` with K6 as its backward (the
    reference's ``_rms_norm_2d`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        y, r = rms_norm(x, weight, epsilon, return_rstd=True)
        ctx.save_for_backward(x, weight, r)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, r = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, r, dy.contiguous().to(x.dtype))
        return dx, dw, None
