"""Norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch

from .. import functional as F

__all__ = ["RMSNorm"]


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
