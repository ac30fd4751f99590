"""Creation ops (the reference's ``paddle_tpu/tensor/creation.py``) on the
current place's device (``cuda`` unless ``set_device`` said otherwise; they
raise without CUDA unless the caller asked for the CPU). Float ops take the
default dtype (``get_default_dtype()``); ``arange`` of ints is int64."""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..core.dtype import get_default_dtype
from ..core.tensor import to_tensor  # noqa: F401  (re-exported)
from ._helpers import (default_float, ensure_tensor, scalar, shape_arg,
                       to_torch_dtype)

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
    "ones_like", "full_like", "empty_like", "arange", "linspace",
    "logspace", "eye", "diag", "diagflat", "tril", "triu", "meshgrid",
    "assign", "clone", "tril_indices", "triu_indices", "complex", "polar",
    "one_hot",
]



def _dt(dtype):
    return to_torch_dtype(dtype) if dtype is not None else default_float()


def zeros(shape, dtype=None, name=None):
    return torch.zeros(shape_arg(shape), dtype=_dt(dtype),
                       device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(shape_arg(shape), dtype=_dt(dtype),
                      device=resolve_device())


def full(shape, fill_value, dtype=None, name=None):
    """A bool fill makes a bool tensor; any other fill the default float
    dtype unless ``dtype`` says otherwise (paddle's rule)."""
    fill_value = scalar(fill_value)
    if dtype is None:
        dtype = "bool" if isinstance(fill_value, bool) else \
            get_default_dtype()
    return torch.full(shape_arg(shape), fill_value, dtype=_dt(dtype),
                      device=resolve_device())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(ensure_tensor(x), dtype=to_torch_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(ensure_tensor(x), dtype=to_torch_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(ensure_tensor(x), scalar(fill_value),
                           dtype=to_torch_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = scalar(start), scalar(end), scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (get_default_dtype()
                 if any(isinstance(v, float) for v in (start, end, step))
                 else "int64")
    return torch.arange(start, end, step, dtype=to_torch_dtype(dtype),
                        device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(scalar(start), scalar(stop), int(scalar(num)),
                          dtype=_dt(dtype), device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(scalar(start), scalar(stop), int(scalar(num)),
                          base=scalar(base), dtype=_dt(dtype),
                          device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    return torch.eye(n, int(num_columns) if num_columns else n,
                     dtype=_dt(dtype), device=resolve_device())


def diag(x, offset=0, padding_value=0, name=None):
    x = ensure_tensor(x)
    if x.ndim == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
            out = torch.where(mask, out, torch.full_like(out,
                                                         padding_value))
        return out
    return torch.diagonal(x, offset)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(ensure_tensor(x), offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(ensure_tensor(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(ensure_tensor(x), diagonal)


def tril_indices(row, col, offset=0, dtype="int64"):
    return torch.tril_indices(row, col, offset, dtype=to_torch_dtype(dtype),
                              device=resolve_device())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return torch.triu_indices(row, col or row, offset,
                              dtype=to_torch_dtype(dtype),
                              device=resolve_device())


def meshgrid(*args, **kwargs):
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*[ensure_tensor(t) for t in ts],
                               indexing="ij"))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, array, list or number), or written into
    ``output`` and returned."""
    out = ensure_tensor(x).clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    return ensure_tensor(x).clone()


def complex(real, imag, name=None):
    real = ensure_tensor(real)
    return torch.complex(real, ensure_tensor(imag, like=real))


def polar(abs, angle, name=None):
    abs = ensure_tensor(abs)
    return torch.polar(abs, ensure_tensor(angle, like=abs))


def one_hot(x, num_classes, name=None):
    """In the default float dtype, as the reference's."""
    x = ensure_tensor(x)
    return torch.nn.functional.one_hot(x.long(), num_classes).to(
        default_float())
