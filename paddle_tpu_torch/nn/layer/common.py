"""``Linear`` and ``Embedding`` of the port: ``torch.nn``'s, with their
forward through the functionals that hold amp's cast seam
(``nn/functional/common.py``). Subclasses, so ``isinstance(m,
torch.nn.Linear)`` still holds (the weight carry transposes by it)."""
from __future__ import annotations

import torch

from ... import amp
from ...amp import amp_state
from ..functional.common import torch_linear

__all__ = ["Linear", "Embedding"]


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
