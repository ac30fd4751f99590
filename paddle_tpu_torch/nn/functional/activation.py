"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``; ``silu`` is PyTorch's own)."""
from __future__ import annotations

import torch

from ... import amp
from ...amp import amp_state

__all__ = ["softmax"]


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis`` in x's dtype (after a cast to ``dtype`` when
    given); op name ``softmax``, black-listed by amp."""
    if amp_state.enabled:
        (x,) = amp.cast_inputs_for_op("softmax", x)
    if dtype is not None:
        x = x.to(amp._dtype(dtype))
    return torch.softmax(x, dim=axis)
