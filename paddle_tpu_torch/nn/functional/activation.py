"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``): the reference's ``__all__``,
each in x's dtype with the reference's formula. None has a Pallas kernel
in the reference (XLA fuses them), and none has one here: each is one
PyTorch elementwise op or a short chain of them. ``rrelu`` in training
and ``gumbel_softmax`` draw from ``generator`` (a ``torch.Generator`` on
x's device), not from the reference's JAX keys."""
from __future__ import annotations

import torch

from ... import amp
from ...amp import amp_state

__all__ = ["relu", "relu6", "sigmoid", "tanh", "silu", "softsign",
           "tanhshrink", "mish", "log_sigmoid", "relu_", "gelu", "swish",
           "softmax", "softmax_", "log_softmax", "leaky_relu", "elu", "elu_",
           "selu", "celu", "hardshrink", "softshrink", "hardsigmoid",
           "hardswish", "hardtanh", "softplus", "thresholded_relu", "prelu",
           "rrelu", "glu", "maxout", "gumbel_softmax"]

_tF = torch.nn.functional


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis`` in x's dtype (after a cast to ``dtype`` when
    given); op name ``softmax``, black-listed by amp."""
    if amp_state.enabled:
        (x,) = amp.cast_inputs_for_op("softmax", x)
    if dtype is not None:
        x = x.to(amp._dtype(dtype))
    return torch.softmax(x, dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(amp._dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def gelu(x, approximate=False, name=None):
    """GELU in x's dtype: the erf form by default, as paddle's (and the
    reference's ``F.gelu``); ``approximate=True`` the tanh form, which is
    ``jax.nn.gelu``'s default and what the reference's fused stack and MoE
    experts call."""
    return _tF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)


def relu(x, name=None):
    return torch.relu(x)


def relu_(x, name=None):
    return x.relu_()


def relu6(x, name=None):
    return _tF.relu6(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def silu(x, name=None):
    return _tF.silu(x)


def swish(x, name=None):
    return _tF.silu(x)


def softsign(x, name=None):
    return _tF.softsign(x)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def mish(x, name=None):
    """``x * tanh(softplus(x))`` with ``jax.nn.softplus`` (no threshold)."""
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def log_sigmoid(x, name=None):
    return _tF.logsigmoid(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _tF.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0, name=None):
    return _tF.elu(x, alpha)


def elu_(x, alpha=1.0, name=None):
    return x.copy_(elu(x, alpha))


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return _tF.celu(x, alpha)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002 (paddle's names)
    return torch.clamp(x, min, max)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(beta * x > threshold, x,
                       (1.0 / beta) * torch.log1p(torch.exp(beta * x)))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x >= 0, x, w * x)``; a weight of more than one element is
    per channel (axis 1 under ``NC*``, else the last)."""
    if weight.numel() > 1:
        ch = 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1
        shape = [1] * x.dim()
        shape[ch] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False,
          name=None, generator=None):
    """Randomized leaky ReLU: in training each negative element's slope is
    drawn uniformly from ``[lower, upper)`` (from ``generator``); outside
    training the slope is their mean."""
    if training:
        slope = torch.empty_like(x).uniform_(lower, upper,
                                             generator=generator)
        return torch.where(x >= 0, x, x * slope)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def glu(x, axis=-1, name=None):
    return _tF.glu(x, dim=axis)


def maxout(x, groups, axis=1, name=None):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` drawn
    from ``generator``; ``hard`` returns the one-hot argmax forward with
    the soft gradient (straight-through)."""
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard + (y - y.detach())
    return y
