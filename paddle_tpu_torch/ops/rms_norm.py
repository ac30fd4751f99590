"""RMSNorm forward: the Hopper kernel K1 and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/rms_norm.py`` (forward only; the
backward kernel belongs to the training slice). Rows are all leading dims
flattened; the last axis is normalized. Math in f32:

    r = rsqrt(mean(x^2) + eps)        y = x * r * w

The CUDA source is ``paddle_tpu_torch/csrc/rms_norm.cu``.
"""
from __future__ import annotations

import torch

from . import _library as L

__all__ = ["rms_norm", "rms_norm_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_plain(x, weight, epsilon=1e-6):
    """Plain version of K1: returns ``(y, rstd)``, ``rstd`` shaped
    ``x.shape[:-1]`` in f32."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    y = (xf * r * weight.float()).to(x.dtype)
    return y, r.squeeze(-1)


def rms_norm(x, weight, epsilon=1e-6, return_rstd=False):
    """RMSNorm over the last axis; ``x`` (..., N), ``weight`` (N,).

    CPU tensors run :func:`rms_norm_plain`; CUDA tensors launch the
    kernel, or raise on a dtype, shape or layout it does not take. With
    ``return_rstd`` also returns the per-row ``rsqrt(mean(x^2) + eps)``
    that the TPU kernel saves for its backward."""
    if weight.dim() != 1 or x.shape[-1] != weight.shape[0]:
        raise ValueError(
            f"rms_norm: weight {tuple(weight.shape)} does not match the last "
            f"axis of x {tuple(x.shape)}")
    if L.use_plain(x):
        y, r = rms_norm_plain(x, weight, epsilon)
        return (y, r) if return_rstd else y
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(
            f"rms_norm kernel takes float32 or bfloat16 x with a weight of "
            f"the same dtype, got {x.dtype} and {weight.dtype}")
    if weight.device != x.device:
        raise ValueError("rms_norm: x and weight lie on different devices")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous x and weight")
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
