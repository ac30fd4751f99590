"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``).

Weights are paddle's layout, (out, in/groups, *k) and, for the
transposes, (in, out/groups, *k), which are torch's too: they carry
across untransposed. Default init as the reference's: weight and bias
``Uniform(-k, k)`` with ``k = 1 / sqrt(in * prod(kernel) / groups)``,
drawn from ``generator`` when given; ``bias_attr=False`` drops the bias.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _tuplize(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, n, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0, device=None, dtype=None):
        super().__init__()
        self._n = n
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _tuplize(kernel_size, n)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        self._output_padding = output_padding
        if transpose:
            w_shape = (in_channels, out_channels // groups) + self._kernel_size
        else:
            w_shape = (out_channels, in_channels // groups) + self._kernel_size
        kw = dict(device=device, dtype=dtype)
        self.weight = torch.nn.Parameter(torch.empty(w_shape, **kw))
        self.bias = (None if bias_attr is False else
                     torch.nn.Parameter(torch.empty(out_channels, **kw)))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in = (self._in_channels * math.prod(self._kernel_size)
                  // self._groups)
        k = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            self.weight.uniform_(-k, k, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-k, k, generator=generator)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, dtype=None):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, dtype=None):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class _ConvTransposeNd(_ConvNd):
    _fn = None

    def __init__(self, n, in_channels, out_channels, kernel_size, stride,
                 padding, output_padding, groups, dilation, weight_attr,
                 bias_attr, data_format, device, dtype):
        super().__init__(n, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         dtype=dtype)

    def forward(self, x, output_size=None):
        return self._fn(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation, output_size,
            self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, dtype=None):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device, dtype)


class Conv2DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device, dtype)


class Conv3DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, dtype=None):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device, dtype)
