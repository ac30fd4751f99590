"""Products and lookups with amp's cast seam (counterpart of the
reference's ``linear`` in ``paddle_tpu/nn/functional/common.py`` and
``matmul`` in ``paddle_tpu/tensor/linalg.py``), and the reference's
resampling and layout functionals of the same file: ``interpolate`` /
``upsample``, ``pixel_shuffle`` / ``pixel_unshuffle``,
``channel_shuffle``, ``zeropad2d`` and ``pad`` (from
``paddle_tpu/tensor/manipulation.py``).

Inputs of one dtype take PyTorch's own product. Mixed dtypes (a bf16
base weight and f32 LoRA factors outside amp) follow the reference: the
product runs in the promoted dtype and, when the left operand is bf16 or
fp16, comes back in that dtype (the reference's f32-accumulated product
cast to the input's dtype); a bias is then added in the output's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import amp
from ...amp import amp_state

__all__ = ["linear", "matmul", "embedding", "dropout", "interpolate",
           "upsample", "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "zeropad2d", "pad"]

_HALF = (torch.bfloat16, torch.float16)


def _mixed(op, x, y):
    """``op(x, y)`` of two floating tensors of different dtypes, the
    reference's way."""
    common = torch.promote_types(x.dtype, y.dtype)
    out = op(x.to(common), y.to(common))
    return out.to(x.dtype) if x.dtype in _HALF else out


def torch_linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with weight (out, in), torch's layout: the
    product of the port's ``Linear`` (op name ``linear``)."""
    if amp_state.enabled:
        x, weight, bias = amp.cast_inputs_for_op("linear", x, weight, bias)
    if x.dtype == weight.dtype and (bias is None or bias.dtype == x.dtype):
        return torch.nn.functional.linear(x, weight, bias)
    out = (_mixed(torch.nn.functional.linear, x, weight)
           if x.dtype != weight.dtype
           else torch.nn.functional.linear(x, weight))
    return out if bias is None else out + bias.to(out.dtype)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with weight (in, out), paddle's layout."""
    return torch_linear(x, weight.t(), bias)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``paddle.matmul``: ``x @ y``, either operand's last two dims swapped
    first on request."""
    if amp_state.enabled:
        x, y = amp.cast_inputs_for_op("matmul", x, y)
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    if x.dtype == y.dtype:
        return torch.matmul(x, y)
    return _mixed(torch.matmul, x, y)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows ``weight[x]`` (op name ``embedding``); ``padding_idx`` rows
    get no gradient."""
    if amp_state.enabled:
        (weight,) = amp.cast_inputs_for_op("embedding", weight)
    return torch.nn.functional.embedding(x, weight, padding_idx,
                                         sparse=sparse)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """``paddle.nn.functional.dropout``: in training, zero each element
    (or, with ``axis``, each slice along those axes) with probability
    ``p``, the keep mask drawn from ``generator`` (a ``torch.Generator``
    on x's device; the global one when omitted); ``upscale_in_train``
    divides the kept values by ``1 - p``. Outside training it is the
    identity, or a scale by ``1 - p`` under ``downscale_in_infer``. The
    draws are PyTorch's, not the reference's JAX keys."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unsupported dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in
                ((axis,) if isinstance(axis, int) else tuple(axis))}
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``paddle.nn.functional.pad``: ``pad`` of length 2 * ndim pads every
    dim, first dim first; a shorter one pads the trailing spatial dims
    (the ones before the channel under ``N...C``), first spatial dim
    first. Modes ``constant``, ``reflect``, ``replicate``, ``circular``."""
    pad = [int(p) for p in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    nd = x.dim()
    widths = [(0, 0)] * nd
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_sp = len(pad) // 2
        dims = (range(1, 1 + n_sp) if data_format.endswith("C")
                else range(nd - n_sp, nd))
        for i, d in enumerate(dims):
            widths[d] = (pad[2 * i], pad[2 * i + 1])
    last = max((d for d, w in enumerate(widths) if w != (0, 0)), default=-1)
    flat = []
    for lo, hi in reversed(widths[:last + 1]):
        flat += [lo, hi]
    if not flat:
        return x
    if mode == "constant":
        return torch.nn.functional.pad(x, flat, value=value)
    return _pad_edges(x, widths, mode)


def _pad_edges(x, widths, mode):
    """reflect / replicate / circular on any dims, one dim at a time
    (torch's own pads these only on the trailing dims of 2-5-D input)."""
    for d, (lo, hi) in enumerate(widths):
        if lo == 0 and hi == 0:
            continue
        n = x.shape[d]
        i = torch.arange(-lo, n + hi, device=x.device)
        if mode == "replicate":
            i = i.clamp(0, n - 1)
        elif mode == "circular":
            i = i % n
        elif mode == "reflect":
            period = max(2 * (n - 1), 1)
            i = i.abs() % period
            i = torch.where(i >= n, period - i, i)
        else:
            raise ValueError(f"unsupported pad mode {mode!r}")
        x = x.index_select(d, i)
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero padding ``[left, right, top, bottom]`` of the two spatial
    dims."""
    left, right, top, bottom = (int(v) for v in padding)
    if data_format == "NCHW":
        return torch.nn.functional.pad(x, (left, right, top, bottom))
    return torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    v = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    n, c, h, w = x.shape
    v = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return v.reshape(n, c * r * r, h // r, w // r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def _keys_cubic(d):
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = np.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return np.where(d >= 2.0, 0.0, out)


_KERNELS = {"linear": lambda d: np.maximum(0, 1 - np.abs(d)),
            "cubic": _keys_cubic}


def _resize_weights(n_in, n_out, kernel):
    """(n_in, n_out) weights of ``jax.image.resize`` along one axis
    (``scale_and_translate`` with antialiasing: the kernel widens by the
    downsampling factor), in f32 as jax forms them."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5)).astype(f32)
    d = (np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = _KERNELS[kernel](d).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resampling of the spatial dims as the reference defines it:
    ``nearest`` takes source ``floor(i * in / out)`` (f32); linear modes
    with ``align_corners`` interpolate between ``floor(pos)`` and the next
    sample at ``pos = i * (in - 1) / (out - 1)``; otherwise ``bilinear``,
    ``linear``, ``trilinear`` and ``area`` are ``jax.image.resize``'s
    linear (half-pixel centres, antialiased when shrinking) and
    ``bicubic`` its Keys cubic, as per-axis weight matrices."""
    channels_last = not data_format.startswith("NC")
    n_sp = x.dim() - 2
    first = 1 if channels_last else 2
    in_sp = tuple(x.shape[first:first + n_sp])
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        out_sp = tuple(int(s) for s in (size if isinstance(size, (list,
                                                                  tuple))
                                        else [size]))
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n_sp)
        out_sp = tuple(int(d * f) for d, f in zip(in_sp, sf))
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]
    out = x
    for d, (n_in, n_out) in enumerate(zip(in_sp, out_sp)):
        ax = first + d
        if method == "nearest":
            src = np.floor(np.arange(n_out).astype(np.float32)
                           * np.float32(n_in / n_out)).astype(np.int64)
            idx = torch.from_numpy(np.clip(src, 0, n_in - 1)).to(x.device)
            out = out.index_select(ax, idx)
        elif align_corners:
            out = _align_corners(out, ax, n_in, n_out)
        elif n_in != n_out:
            w = torch.from_numpy(_resize_weights(n_in, n_out, method)).to(
                device=x.device, dtype=x.dtype)
            out = torch.tensordot(out, w, dims=([ax], [0])).movedim(-1, ax)
    return out


def _align_corners(x, ax, n_in, n_out):
    if n_out == 1 or n_in == 1:
        pos = np.zeros(n_out, np.float32)
    else:
        pos = (np.arange(n_out) * (n_in - 1)).astype(np.float32) \
            / np.float32(n_out - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    shape = [1] * x.dim()
    shape[ax] = -1
    t = torch.from_numpy((pos - lo).astype(np.float32)).to(
        device=x.device, dtype=x.dtype).reshape(shape)
    lo_t = torch.from_numpy(lo).to(x.device)
    hi_t = torch.from_numpy(hi).to(x.device)
    return (x.index_select(ax, lo_t) * (1 - t)
            + x.index_select(ax, hi_t) * t)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)
