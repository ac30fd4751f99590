"""Comparison and logical ops (the reference's
``paddle_tpu/tensor/logic.py``) on torch."""
from __future__ import annotations

import torch

from ._helpers import apply, ensure_tensor, is_scalar

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "is_empty", "is_tensor",
    "where",
]


def _cmp(tfn, name):
    def op(x, y, name=None):
        if is_scalar(x):
            y = ensure_tensor(y)
            x = torch.as_tensor(x, device=y.device)
        else:
            x = ensure_tensor(x)
            y = y if is_scalar(y) else ensure_tensor(y, like=x)
        return apply(tfn, x, y, op_name=op.__name__)

    op.__name__ = op.__qualname__ = name
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")
logical_and = _cmp(lambda a, b: torch.logical_and(a, torch.as_tensor(b)),
                   "logical_and")
logical_or = _cmp(lambda a, b: torch.logical_or(a, torch.as_tensor(b)),
                  "logical_or")
logical_xor = _cmp(lambda a, b: torch.logical_xor(a, torch.as_tensor(b)),
                   "logical_xor")
bitwise_and = _cmp(torch.bitwise_and, "bitwise_and")
bitwise_or = _cmp(torch.bitwise_or, "bitwise_or")
bitwise_xor = _cmp(torch.bitwise_xor, "bitwise_xor")
bitwise_left_shift = _cmp(torch.bitwise_left_shift, "bitwise_left_shift")
bitwise_right_shift = _cmp(torch.bitwise_right_shift, "bitwise_right_shift")


def logical_not(x, name=None):
    return torch.logical_not(ensure_tensor(x))


def bitwise_not(x, name=None):
    return torch.bitwise_not(ensure_tensor(x))


def is_empty(x, name=None):
    x = ensure_tensor(x)
    return torch.as_tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def where(condition, x=None, y=None, name=None):
    condition = ensure_tensor(condition)
    if x is None and y is None:
        from .search import nonzero

        return nonzero(condition, as_tuple=True)
    if not is_scalar(x):
        x = ensure_tensor(x, like=condition)
    if not is_scalar(y):
        y = ensure_tensor(y, like=condition)
    return torch.where(condition, x, y)
