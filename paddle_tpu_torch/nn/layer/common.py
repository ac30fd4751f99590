"""``Linear`` and ``Embedding`` of the port: ``torch.nn``'s, with their
forward through the functionals that hold amp's cast seam
(``nn/functional/common.py``). Subclasses, so ``isinstance(m,
torch.nn.Linear)`` still holds (the weight carry transposes by it).
``Dropout`` is paddle's, over ``F.dropout``."""
from __future__ import annotations

import torch

from ... import amp
from ...amp import amp_state
from ..functional.common import dropout, torch_linear

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(torch.nn.Linear):
    """``torch.nn.Linear`` (weight (out, in)) under amp's ``linear`` rule
    and the reference's mixed-dtype promotion."""

    def forward(self, x):
        return torch_linear(x, self.weight, self.bias)


class Embedding(torch.nn.Embedding):
    """``torch.nn.Embedding`` under amp's ``embedding`` rule (O2 reads the
    table in the amp dtype)."""

    def forward(self, x):
        w = self.weight
        if amp_state.enabled:
            (w,) = amp.cast_inputs_for_op("embedding", w)
        return torch.nn.functional.embedding(
            x, w, self.padding_idx, self.max_norm, self.norm_type,
            self.scale_grad_by_freq, self.sparse)


class Dropout(torch.nn.Module):
    """``paddle.nn.Dropout``: :func:`~paddle_tpu_torch.nn.functional.dropout`
    in training mode (``self.training``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return dropout(x, self.p, self.axis, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}"
