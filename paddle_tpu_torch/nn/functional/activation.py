"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``; ``silu`` is PyTorch's own)."""
from __future__ import annotations

import torch

from ... import amp
from ...amp import amp_state

__all__ = ["softmax", "gelu", "tanh", "relu"]


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis`` in x's dtype (after a cast to ``dtype`` when
    given); op name ``softmax``, black-listed by amp."""
    if amp_state.enabled:
        (x,) = amp.cast_inputs_for_op("softmax", x)
    if dtype is not None:
        x = x.to(amp._dtype(dtype))
    return torch.softmax(x, dim=axis)


def gelu(x, approximate=False, name=None):
    """GELU in x's dtype: the erf form by default, as paddle's (and the
    reference's ``F.gelu``); ``approximate=True`` the tanh form, which is
    ``jax.nn.gelu``'s default and what the reference's fused stack and MoE
    experts call."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)


def relu(x, name=None):
    return torch.relu(x)
