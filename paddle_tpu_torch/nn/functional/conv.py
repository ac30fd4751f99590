"""Convolution functionals (counterpart of
``paddle_tpu/nn/functional/conv.py``).

The reference runs convolutions as XLA's ``conv_general_dilated`` (no
Pallas kernel); the port runs PyTorch's (cuDNN on the card), with the
reference's arithmetic around it:

- paddings: an int, one per spatial dim, a (before, after) pair per dim
  (flat or as a full-rank list) or ``"SAME"`` / ``"VALID"``. ``"SAME"``
  is split as XLA splits it (``total // 2`` before, the rest after), so an
  odd total at stride 2 pads one more after; torch's ``padding="same"``
  refuses stride > 1, so uneven pads go through an explicit ``F.pad``;
- ``data_format`` ``NHWC`` (``NLC``, ``NDHWC``) is moved to channels
  first around the product and back, so the public layout is paddle's;
- in bf16 and fp16 the product accumulates in f32 and rounds once to x's
  dtype (``preferred_element_type``), and the bias is added after that
  rounding, in the output's dtype;
- the transposes are the reference's ``conv_general_dilated`` over the
  stride-dilated input with the (in, out/groups, k) weight read as IO and
  NOT flipped: torch's ``conv_transpose`` of the spatially flipped weight,
  with the reference's padding arithmetic (``(k - 1) * dilation - pad``
  before, ``... - pad + output_padding`` after) applied to its unpadded
  output by an explicit pad or crop. ``output_size`` is accepted and, as
  in the reference, not read.

Weights are (out, in/groups, *k), paddle's layout and torch's, so they
carry across untransposed.
"""
from __future__ import annotations

import torch

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_tF = torch.nn.functional
_CONV = {1: _tF.conv1d, 2: _tF.conv2d, 3: _tF.conv3d}
_CONV_T = {1: _tF.conv_transpose1d, 2: _tF.conv_transpose2d,
           3: _tF.conv_transpose3d}


def _tuplize(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(i) for i in v)
    return v if len(v) == n else tuple(v[i % len(v)] for i in range(n))


def _padding_arg(padding, n):
    """paddle padding -> ``"SAME"`` / ``"VALID"`` or n (before, after)
    pairs (the reference's ``_padding_arg``)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding[-n:]]
    raise ValueError(f"unsupported padding spec {padding}")


def _same_pads(sizes, windows, strides):
    """XLA's ``"SAME"`` split: output ``ceil(in / stride)``, the total pad
    ``total // 2`` before and the rest after."""
    pads = []
    for size, win, st in zip(sizes, windows, strides):
        out = -(-size // st)
        total = max((out - 1) * st + win - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pairs):
    """n (before, after) pairs -> ``F.pad``'s flat list (last dim first)."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


def _channels_last(x, data_format):
    return not data_format.startswith("NC") and x.dim() > 2


def _add_bias(out, bias, n):
    return out + bias.reshape((1, -1) + (1,) * n).to(out.dtype)


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          n):
    strides = _tuplize(stride, n)
    dilations = _tuplize(dilation, n)
    moved = _channels_last(x, data_format)
    if moved:
        x = x.movedim(-1, 1)
    pad = _padding_arg(padding, n)
    if pad == "VALID":
        pad = [(0, 0)] * n
    elif pad == "SAME":
        windows = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:],
                                                   dilations)]
        pad = _same_pads(x.shape[2:], windows, strides)
    if all(lo == hi for lo, hi in pad):
        sym = tuple(lo for lo, _ in pad)
    else:
        x = _tF.pad(x, _torch_pad(pad))
        sym = 0
    out = _CONV[n](x, weight, None, strides, sym, dilations, groups)
    if bias is not None:
        out = _add_bias(out, bias, n)
    return out.movedim(1, -1) if moved else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n):
    strides = _tuplize(stride, n)
    dilations = _tuplize(dilation, n)
    opad = _tuplize(output_padding, n)
    pad = _padding_arg(padding, n)
    moved = _channels_last(x, data_format)
    if moved:
        x = x.movedim(-1, 1)
    span = [(k - 1) * d for k, d in zip(weight.shape[2:], dilations)]
    if isinstance(pad, str):
        if any(s != 1 for s in strides):
            # what the reference's conv_general_dilated raises
            raise ValueError(
                "String padding is not implemented for transposed "
                "convolution using this op. Please either exactly specify "
                "the required padding or use conv_transpose.")
        cfg = ([(0, 0)] * n if pad == "VALID" else
               _same_pads(x.shape[2:], [s + 1 for s in span], strides))
    else:
        cfg = [(k - lo, k - hi + op) for k, (lo, hi), op in zip(span, pad,
                                                                 opad)]
    # torch's unpadded transpose is the correlation over the dilated input
    # padded by `span` on both sides: pad or crop the difference
    out = _CONV_T[n](x, weight.flip(list(range(2, 2 + n))), None, strides,
                     0, 0, groups, dilations)
    edges = [(lo - k, hi - k) for k, (lo, hi) in zip(span, cfg)]
    if any(e for pair in edges for e in pair):
        out = _tF.pad(out, _torch_pad(edges))
    if bias is not None:
        out = _add_bias(out, bias, n)
    return out.movedim(1, -1) if moved else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3)
