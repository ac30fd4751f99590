"""Norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch

from .. import functional as F

__all__ = ["RMSNorm", "LayerNorm"]


class RMSNorm(torch.nn.Module):
    """The Llama-family norm: K1 forward, K6 backward (``F.rms_norm``)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, epsilon={self.epsilon}"


class LayerNorm(torch.nn.Module):
    """``paddle.nn.LayerNorm``: weight 1 and bias 0 over
    ``normalized_shape`` (``weight_attr`` / ``bias_attr`` False drops
    them), through :func:`~paddle_tpu_torch.nn.functional.layer_norm`."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = (None if weight_attr is False else torch.nn.Parameter(
            torch.ones(self._normalized_shape, **kw)))
        self.bias = (None if bias_attr is False else torch.nn.Parameter(
            torch.zeros(self._normalized_shape, **kw)))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={list(self._normalized_shape)}, "
                f"epsilon={self._epsilon}")
