"""Shared helpers for the op corpus."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.dtype import default_float, to_torch_dtype
from ..core.tensor import to_tensor

__all__ = ["apply", "to_torch_dtype", "ensure_tensor", "axes_arg",
           "scalar", "default_float", "is_scalar", "shape_arg"]

_SCALARS = (bool, int, float, complex, np.bool_, np.integer, np.floating)


def is_scalar(x):
    return isinstance(x, _SCALARS)


def ensure_tensor(x, dtype=None, like=None):
    """A tensor as it is; anything else through ``to_tensor``, on
    ``like``'s device when given (else the current place's)."""
    if isinstance(x, torch.Tensor):
        return x
    return to_tensor(x, dtype=dtype,
                     place=like.device if isinstance(like, torch.Tensor)
                     else None)


def axes_arg(axis):
    """Normalize paddle's axis argument (int | list | tuple | Tensor |
    None) to an int, a tuple of ints or None."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def shape_arg(shape):
    """paddle's shape argument (an int, a list of ints or one-element
    tensors, or a tensor) as a tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def scalar(v):
    """A python number from a number or a one-element tensor."""
    return v.item() if isinstance(v, torch.Tensor) else v
