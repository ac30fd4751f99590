"""Pooling functionals (counterpart of
``paddle_tpu/nn/functional/pooling.py``).

The reference pools with XLA's ``reduce_window`` over an explicitly
padded window grid (no Pallas kernel); the port pads the same way with
``F.pad`` and pools with PyTorch's (unpadded) ``max_pool`` / ``avg_pool``:

- ``ceil_mode`` adds the reference's extra right padding (enough that the
  last window fits, ``(stride - (in + pads - k) % stride) % stride``),
  where torch's own ``ceil_mode`` would drop a window that starts in the
  right padding;
- max pooling pads with ``-inf``; average pooling sums over the padded
  grid and divides by the count of in-bounds elements when ``exclusive``
  (the reference's ``reduce_window`` over ones), else by the window's
  size;
- adaptive pooling takes the windows ``[floor(i * in / out), ceil((i + 1)
  * in / out))``, which are torch's own; ``return_mask`` of the adaptive
  pools is accepted and, as in the reference, not honoured;
- ``max_pool2d(return_mask=True)`` returns the flat per-plane argmax of
  the unpadded windows (the reference's ``_pool_indices``), int32.

``NHWC`` layouts are moved to channels first around the pool and back.
"""
from __future__ import annotations

import math

import torch

from .conv import _padding_arg, _torch_pad, _tuplize

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool1d", "max_unpool2d"]

_tF = torch.nn.functional
# avg_pool1d has no divisor_override: 1-D pools run as 2-D over (1, L)
_MAX = {2: _tF.max_pool2d, 3: _tF.max_pool3d}
_AVG = {2: _tF.avg_pool2d, 3: _tF.avg_pool3d}


def _pad_pairs(sizes, ks, st, pad, ceil_mode):
    """The reference's ``pad_config``: (before, after) per spatial dim."""
    if pad == "VALID":
        pairs = [(0, 0)] * len(sizes)
    elif pad == "SAME":
        pairs = []
        for dim, k, s in zip(sizes, ks, st):
            total = max((-(-dim // s) - 1) * s + k - dim, 0)
            pairs.append((total // 2, total - total // 2))
    else:
        pairs = list(pad)
    if ceil_mode:
        out = []
        for dim, k, s, (lo, hi) in zip(sizes, ks, st, pairs):
            eff = dim + lo + hi
            extra = (s - (eff - k) % s) % s if eff >= k else 0
            out.append((lo, hi + extra))
        pairs = out
    return pairs


def _pool(x, kernel, stride, padding, n, reducer, data_format,
          ceil_mode=False, exclusive=True):
    ks = _tuplize(kernel, n)
    st = _tuplize(stride if stride is not None else kernel, n)
    moved = not data_format.startswith("NC")
    if moved:
        x = x.movedim(-1, 1)
    pairs = _pad_pairs(x.shape[2:], ks, st, _padding_arg(padding, n),
                       ceil_mode)
    flat = _torch_pad(pairs)
    lifted = n == 1
    if lifted:
        x, ks, st = x.unsqueeze(2), (1,) + ks, (1,) + st
        flat = flat + [0, 0]
    m = len(ks)
    if reducer == "max":
        fill = (-math.inf if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
        out = _MAX[m](_tF.pad(x, flat, value=fill), ks, st)
    else:
        summed = _AVG[m](_tF.pad(x, flat), ks, st, divisor_override=1)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = summed / _AVG[m](_tF.pad(ones, flat), ks, st,
                                   divisor_override=1)
        else:
            out = summed / float(math.prod(ks))
    if lifted:
        out = out.squeeze(2)
    return out.movedim(1, -1) if moved else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "max", data_format,
                 ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 2, "max", data_format,
                ceil_mode)
    if return_mask:
        return out, _pool_indices(x, kernel_size, stride)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, "max", data_format,
                 ceil_mode)


def _pool_indices(x, kernel_size, stride):
    """Flat per-plane argmax over the unpadded (VALID) windows, NCHW, as
    the reference's ``_pool_indices`` (first maximum on ties)."""
    ks = _tuplize(kernel_size, 2)
    st = _tuplize(stride if stride is not None else kernel_size, 2)
    _, idx = _tF.max_pool2d(x.float(), ks, st, return_indices=True)
    return idx.to(torch.int32)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", data_format,
                 ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg", data_format,
                 ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", data_format,
                 ceil_mode, exclusive)


_ADAPTIVE = {("avg", 1): _tF.adaptive_avg_pool1d,
             ("avg", 2): _tF.adaptive_avg_pool2d,
             ("avg", 3): _tF.adaptive_avg_pool3d,
             ("max", 1): _tF.adaptive_max_pool1d,
             ("max", 2): _tF.adaptive_max_pool2d,
             ("max", 3): _tF.adaptive_max_pool3d}


def _adaptive_pool(x, output_size, n, mode, data_format):
    if isinstance(output_size, int) or output_size is None:
        sizes = (output_size,) * n
    else:
        sizes = tuple(output_size)
    moved = not data_format.startswith("NC")
    if moved:
        x = x.movedim(-1, 1)
    out = _ADAPTIVE[mode, n](x, sizes[0] if n == 1 else sizes)
    return out.movedim(1, -1) if moved else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 1, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 3, "max", "NCDHW")


def _unpool(x, indices, n, kernel_size, stride, padding, output_size):
    ks = _tuplize(kernel_size, n)
    st = _tuplize(stride if stride is not None else kernel_size, n)
    pd = _tuplize(padding, n)
    if output_size is not None:
        size = [int(v) for v in list(output_size)[-n:]]
    else:
        size = [(x.shape[2 + i] - 1) * st[i] - 2 * pd[i] + ks[i]
                for i in range(n)]
    lead = x.shape[:2]
    flat = x.reshape(lead[0] * lead[1], -1)
    out = torch.zeros((flat.shape[0], math.prod(size)), dtype=x.dtype,
                      device=x.device)
    out.scatter_(1, indices.reshape(flat.shape).long(), flat)
    return out.reshape(*lead, *size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Scatter pooled values back to the flat per-plane positions that
    ``max_pool2d(return_mask=True)`` recorded (NCHW only, as the
    reference)."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d supports NCHW")
    return _unpool(x, indices, 2, kernel_size, stride, padding, output_size)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    if data_format != "NCL":
        raise ValueError("max_unpool1d supports NCL")
    return _unpool(x, indices, 1, kernel_size, stride, padding, output_size)
