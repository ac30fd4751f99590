"""``to_tensor`` and ``Parameter`` on torch.

The reference wraps an immutable ``jax.Array`` in its own ``Tensor``
(``paddle_tpu/core/tensor.py``). Here the tensor is ``torch.Tensor`` and
a parameter is a ``torch.nn.Parameter``: ``Parameter(value, ...)`` builds
one with paddle's signature, and every torch parameter is an instance of
it.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .dtype import default_float, to_torch_dtype

__all__ = ["Tensor", "Parameter", "to_tensor"]

Tensor = torch.Tensor


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new tensor holding a copy of ``data`` on
    ``place`` (default: the current place, ``cuda`` unless ``set_device``
    said otherwise). Without ``dtype``, python floats and float64 arrays
    take the default dtype (``get_default_dtype()``), everything else keeps
    its own (python ints int64, bools bool), the reference's rule."""
    dev = resolve_device(place)
    dt = to_torch_dtype(dtype)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=dev, dtype=dt or data.dtype, copy=True)
    else:
        if isinstance(data, (list, tuple)) and any(
                isinstance(e, torch.Tensor) for e in data):
            data = [e.detach().cpu().numpy() if isinstance(e, torch.Tensor)
                    else e for e in data]
        arr = np.asarray(data)
        if dt is None:
            dt = (default_float() if arr.dtype == np.float64
                  else to_torch_dtype(arr.dtype))
        out = torch.tensor(arr).to(device=dev, dtype=dt)
    if not stop_gradient:
        out.requires_grad_(True)
    return out


class _ParameterMeta(type(torch.nn.Parameter)):
    def __instancecheck__(cls, obj):
        return isinstance(obj, torch.nn.Parameter)


class Parameter(torch.nn.Parameter, metaclass=_ParameterMeta):
    """paddle's ``Parameter(value, dtype=None, name=None, trainable=True)``:
    returns a ``torch.nn.Parameter`` (on ``value``'s device when it is a
    tensor, else on the current place's), its name as ``param_name``
    (torch's ``name`` is read-only); ``isinstance`` holds for every torch
    parameter."""

    def __new__(cls, value, dtype=None, name=None, trainable=True):
        place = value.device if isinstance(value, torch.Tensor) else None
        p = torch.nn.Parameter(to_tensor(value, dtype=dtype, place=place),
                               requires_grad=bool(trainable))
        if name is not None:
            p.param_name = name
        return p
