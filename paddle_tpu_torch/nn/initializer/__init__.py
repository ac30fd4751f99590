"""Weight initializers (the reference's ``paddle_tpu/nn/initializer``).
Each is a callable ``(shape, dtype=float32, device=None) -> tensor`` on
``device`` (default: the current place's), drawing from torch's generator
there; called with a tensor instead of a shape it fills that tensor in
place. The random draws are torch's, not the reference's threefry: the
distributions and their parameters are the reference's."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..._device import resolve_device
from ...core.dtype import to_torch_dtype

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
    "set_global_initializer",
]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    return gains[nonlinearity]


def _fans(shape):
    """The reference's fans: (in, out) = shape for 2-D (paddle's Linear
    weight is (in, out)); for a conv kernel (out, in, *k) the receptive
    field multiplies both."""
    shape = tuple(int(s) for s in shape)
    if len(shape) < 2:
        n = int(np.prod(shape)) if shape else 1
        return n, n
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape_or_tensor, dtype=torch.float32, device=None):
        if isinstance(shape_or_tensor, torch.Tensor):
            t = shape_or_tensor
            with torch.no_grad():
                t.copy_(self._make(tuple(t.shape), t.dtype, t.device))
            return t
        return self._make(tuple(int(s) for s in shape_or_tensor),
                          to_torch_dtype(dtype), resolve_device(device))

    def _make(self, shape, dtype, device):
        raise NotImplementedError


def _f32(dtype):
    return dtype if dtype.is_floating_point else torch.float32


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _make(self, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _make(self, shape, dtype, device):
        z = torch.randn(shape, dtype=_f32(dtype), device=device)
        return (self.mean + self.std * z).to(dtype)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _make(self, shape, dtype, device):
        z = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b)
        return (self.mean + self.std * z).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _make(self, shape, dtype, device):
        u = torch.empty(shape, dtype=torch.float32, device=device)
        return u.uniform_(self.low, self.high).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _make(self, shape, dtype, device):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (std * torch.randn(shape, dtype=torch.float32,
                                  device=device)).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _make(self, shape, dtype, device):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        u = torch.empty(shape, dtype=torch.float32, device=device)
        return u.uniform_(-limit, limit).to(dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _make(self, shape, dtype, device):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        std = calculate_gain(self.nonlinearity,
                             self.negative_slope) / math.sqrt(fi)
        return (std * torch.randn(shape, dtype=torch.float32,
                                  device=device)).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _make(self, shape, dtype, device):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        limit = calculate_gain(self.nonlinearity,
                               self.negative_slope) * math.sqrt(3.0 / fi)
        u = torch.empty(shape, dtype=torch.float32, device=device)
        return u.uniform_(-limit, limit).to(dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _make(self, shape, dtype, device):
        v = self.value
        v = (v.detach() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v)))
        return v.to(device=device, dtype=dtype).reshape(shape)


class Orthogonal(Initializer):
    """The reference's construction: QR of an n x n normal draw, columns
    signed by R's diagonal, the leading (rows, cols) block, times gain."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _make(self, shape, dtype, device):
        rows, cols = shape[0], int(np.prod(shape[1:]))
        n = max(rows, cols)
        a = torch.randn((n, n), dtype=torch.float32, device=device)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def _make(self, shape, dtype, device):
        out = np.zeros(shape, np.float32)
        centers = tuple(s // 2 for s in shape[2:])
        for i in range(min(shape[0], shape[1])):
            out[(i, i) + centers] = 1.0
        return torch.as_tensor(out).to(device=device, dtype=dtype)


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Stored, as the reference stores it (its ``create_parameter`` does not
    read it either)."""
    global _global_weight_init, _global_bias_init
    _global_weight_init, _global_bias_init = weight_init, bias_init
