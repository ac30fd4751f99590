"""The rest of the reference's top-level tensor ops
(``paddle_tpu/tensor/extras.py``) on torch; its linalg tail (``cond``,
``lu_unpack``, ``householder_product``, ``matrix_exp``, ``inverse``)
lives in ``linalg``."""
from __future__ import annotations

import numpy as np
import torch

from ._helpers import ensure_tensor, to_torch_dtype

__all__ = [
    "add_n", "broadcast_shape", "diag_embed", "dsplit", "hsplit", "vsplit",
    "i1", "index_fill", "is_complex", "is_floating_point",
    "logcumsumexp", "masked_scatter", "rank", "renorm", "sgn", "shape",
    "signbit", "tensordot", "trace", "unflatten", "vander", "is_integer",
    "tolist",
]


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors, left to right."""
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    ts = [ensure_tensor(t) for t in inputs]
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(ensure_tensor(input), offset, dim1, dim2)


def _split_along(x, num_or_indices, axis, name):
    from .manipulation import split

    if isinstance(num_or_indices, (list, tuple)):
        # numpy's h / v / dsplit: a list holds split indices
        bounds = [0] + [int(i) for i in num_or_indices] + [x.shape[axis]]
        return split(x, [b - a for a, b in zip(bounds, bounds[1:])],
                     axis=axis)
    return split(x, num_or_indices, axis=axis)


def hsplit(x, num_or_indices, name=None):
    x = ensure_tensor(x)
    return _split_along(x, num_or_indices, 0 if x.ndim == 1 else 1, name)


def vsplit(x, num_or_indices, name=None):
    return _split_along(ensure_tensor(x), num_or_indices, 0, name)


def dsplit(x, num_or_indices, name=None):
    return _split_along(ensure_tensor(x), num_or_indices, 2, name)


def i1(x, name=None):
    from .math import _special

    return _special(torch.special.i1)(ensure_tensor(x))


def index_fill(x, index, axis, value, name=None):
    x = ensure_tensor(x)
    return torch.index_fill(x, axis,
                            ensure_tensor(index, like=x).reshape(-1).long(),
                            value)


def is_complex(x):
    return ensure_tensor(x).is_complex()


def is_floating_point(x):
    return ensure_tensor(x).is_floating_point()


def is_integer(x):
    x = ensure_tensor(x)
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    from .math import _scan

    x = ensure_tensor(x)
    dt = to_torch_dtype(dtype)
    v = x.to(dt) if dt is not None else x
    return _scan(torch.logcumsumexp, v.reshape(-1) if axis is None else v,
                 0 if axis is None else axis)


def masked_scatter(x, mask, value, name=None):
    """True positions of ``mask`` take ``value``'s elements in order."""
    x = ensure_tensor(x)
    mask = ensure_tensor(mask, like=x)
    value = ensure_tensor(value, like=x)
    need = int(torch.broadcast_to(mask, x.shape).sum())
    if value.numel() < need:
        raise ValueError(
            f"masked_scatter: mask selects {need} elements but value has "
            f"only {value.numel()}")
    return torch.masked_scatter(x, mask, value.to(x.dtype))


def rank(input, name=None):
    x = ensure_tensor(input)
    return torch.as_tensor(x.ndim, dtype=torch.int32, device=x.device)


def renorm(x, p, axis, max_norm, name=None):
    """Slices along ``axis`` whose p-norm exceeds ``max_norm`` scaled to
    it, by the reference's formula (norm in f32, max_norm / (norm +
    1e-7))."""
    x = ensure_tensor(x)
    moved = x.movedim(axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.linalg.vector_norm(flat.float(), ord=p, dim=1)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
    out = flat * scale[:, None].to(x.dtype)
    return out.reshape(moved.shape).movedim(0, axis)


def sgn(x, name=None):
    return torch.sgn(ensure_tensor(x))


def shape(input, name=None):
    """The runtime shape as a 1-D int32 tensor (paddle.shape)."""
    x = ensure_tensor(input)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def signbit(x, name=None):
    return torch.signbit(ensure_tensor(x))


def tensordot(x, y, axes=2, name=None):
    x = ensure_tensor(x)
    y = ensure_tensor(y, like=x)
    ax = axes.tolist() if isinstance(axes, torch.Tensor) else axes
    if isinstance(ax, (list, tuple)):
        entries = [list(a) if isinstance(a, (list, tuple)) else a
                   for a in ax]
        if all(isinstance(a, int) for a in entries):
            ax = (entries, entries)     # a flat list names both tensors'
        elif len(entries) == 1:
            ax = (entries[0], entries[0])
        else:
            ax = tuple(entries[:2])
    return torch.tensordot(x, y, dims=ax)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(ensure_tensor(x), offset, axis1, axis2).sum(-1)


def unflatten(x, axis, shape, name=None):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return torch.unflatten(ensure_tensor(x), axis, tuple(shape))


def vander(x, n=None, increasing=False, name=None):
    x = ensure_tensor(x)
    powers = torch.arange(n if n is not None else x.shape[0],
                          device=x.device)
    if not increasing:
        powers = powers.flip(0)
    return x[:, None] ** powers[None, :].to(x.dtype)


def tolist(x):
    return ensure_tensor(x).tolist()


