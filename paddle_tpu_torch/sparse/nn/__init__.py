"""``paddle.sparse.nn``: activation layers on sparse tensors (counterpart
of ``paddle_tpu/sparse/nn/__init__.py``)."""
from __future__ import annotations

import torch

from ...nn.layer.layers import Layer

__all__ = ["ReLU", "Softmax"]


class ReLU(Layer):
    def forward(self, x):
        from .. import relu

        return relu(x)


class Softmax(Layer):
    """Row-wise softmax over a 2-D COO matrix's stored values (implicit
    zeros take no part)."""

    def __init__(self, axis=-1):
        super().__init__()
        if axis != -1:
            raise ValueError("sparse Softmax supports axis=-1 (rows)")

    def forward(self, x):
        from .. import SparseCooTensor, _coo

        x = _coo(x)
        rows, v = x._indices[0], x._values
        n_rows = x._shape[0]
        row_max = torch.full((n_rows,), -torch.inf, dtype=v.dtype,
                             device=v.device).scatter_reduce(
            0, rows, v.detach(), "amax")
        e = torch.exp(v - row_max[rows])
        row_sum = e.new_zeros(n_rows).index_add(0, rows, e)
        return SparseCooTensor(x._indices, e / row_sum[rows], x._shape)
