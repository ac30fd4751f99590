"""``paddle.sparse``: COO and CSR sparse tensors (counterpart of
``paddle_tpu/sparse/__init__.py``).

A :class:`SparseCooTensor` holds its (ndim, nnz) int64 indices, a dense
``values`` tensor and its shape; a :class:`SparseCsrTensor` holds
(crows, cols, values) of a 2-D matrix and computes through its COO form.
``to_torch()`` gives the same data as torch's own sparse tensor. The ops
compute on ``values`` with gathers and index-adds, the reference's BCOO
lowering, so autograd flows to ``values`` (and to the dense operands)
through ``to_dense``, ``matmul``, ``masked_matmul``, ``add``,
``multiply`` and the unary ops. Indices are kept as given: ``add`` sums
duplicates (its result is coalesced, sorted row-major), the other ops
keep their input's pattern.
"""
from __future__ import annotations

import builtins

import torch

from .._device import resolve_device
from ..core.dtype import to_torch_dtype
from ..core.tensor import Tensor  # noqa: F401  (the reference's name)
from ..tensor._helpers import apply, ensure_tensor  # noqa: F401
from . import nn  # noqa: F401

__all__ = [
    "SparseCooTensor", "SparseCsrTensor",
    "sparse_coo_tensor", "sparse_csr_tensor", "to_sparse_coo", "to_dense",
    "is_sparse_coo", "is_sparse_csr",
    "add", "multiply", "matmul", "masked_matmul",
    "relu", "sin", "tanh", "abs", "sqrt", "square", "neg", "pow",
    "nn",
]


def _index(t, device):
    return torch.as_tensor(t, device=device).to(torch.int64)


def _scatter_dense(indices, values, shape):
    """The dense tensor of (indices, values), duplicates summed."""
    out = values.new_zeros(tuple(shape) + tuple(values.shape[1:]))
    return out.index_put(tuple(indices), values, accumulate=True)


class SparseCooTensor:
    """COO sparse tensor: ``indices`` (ndim, nnz), ``values`` (nnz, ...)
    (autograd flows through it), ``shape``."""

    is_sparse = True

    def __init__(self, indices, values, shape):
        self._values = values
        self._indices = _index(indices, values.device)
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    def indices(self):
        return self._indices

    def values(self):
        return self._values

    def nnz(self):
        return int(self._indices.shape[1])

    @property
    def stop_gradient(self):
        return not self._values.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v):
        if not v and not self._values.requires_grad:
            self._values.requires_grad_(True)
        elif v and self._values.requires_grad and self._values.is_leaf:
            self._values.requires_grad_(False)

    def to_dense(self):
        return _scatter_dense(self._indices, self._values, self._shape)

    def to_torch(self):
        """torch's ``sparse_coo_tensor`` of the same indices and values."""
        return torch.sparse_coo_tensor(self._indices, self._values,
                                       self._shape)

    def coalesce(self):
        """Duplicates summed, indices sorted row-major."""
        idx, vals = _coalesce(self._indices, self._values, self._shape)
        return SparseCooTensor(idx, vals, self._shape)

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


class SparseCsrTensor:
    """CSR sparse matrix (2-D): ``crows`` (rows + 1,), ``cols`` (nnz,),
    ``values`` (nnz,); its ops run on its COO form (the same values)."""

    is_sparse = True

    def __init__(self, crows, cols, values, shape):
        self._values = values
        self._crows = _index(crows, values.device)
        self._cols = _index(cols, values.device)
        self._shape = tuple(int(s) for s in shape)
        if len(self._shape) != 2:
            raise ValueError("SparseCsrTensor supports 2-D only")

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    def crows(self):
        return self._crows

    def cols(self):
        return self._cols

    def values(self):
        return self._values

    def nnz(self):
        return int(self._cols.shape[0])

    def to_sparse_coo(self):
        counts = self._crows[1:] - self._crows[:-1]
        rows = torch.repeat_interleave(
            torch.arange(self._shape[0], device=self._cols.device), counts)
        return SparseCooTensor(torch.stack([rows, self._cols]),
                               self._values, self._shape)

    def to_dense(self):
        return self.to_sparse_coo().to_dense()

    def to_torch(self):
        """torch's ``sparse_csr_tensor`` of the same rows and values."""
        return torch.sparse_csr_tensor(self._crows, self._cols,
                                       self._values, self._shape)

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


def _values_of(values, dtype, place, stop_gradient):
    values = ensure_tensor(values)
    if dtype is not None:
        values = values.to(to_torch_dtype(dtype))
    if place is not None:
        values = values.to(resolve_device(place))
    if not stop_gradient and not values.requires_grad:
        values.requires_grad_(True)
    return values


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True):
    """A :class:`SparseCooTensor`; ``shape`` defaults to each index
    row's max plus one. It requires grad when ``values`` does or when
    ``stop_gradient`` is False."""
    values = _values_of(values, dtype, place, stop_gradient)
    idx = _index(indices, values.device)
    if shape is None:
        shape = tuple(int(m) + 1 for m in idx.amax(dim=1).tolist())
    return SparseCooTensor(idx, values, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    values = _values_of(values, dtype, place, stop_gradient)
    return SparseCsrTensor(crows, cols, values, shape)


def to_sparse_coo(x, sparse_dim=None):
    """Dense -> :class:`SparseCooTensor` of its nonzeros in row-major
    order; the values are gathered from ``x``, so gradients reach it."""
    x = ensure_tensor(x)
    idx = torch.nonzero(x).t()
    return SparseCooTensor(idx, x[tuple(idx)], x.shape)


def to_dense(x):
    return x.to_dense() if hasattr(x, "to_dense") else ensure_tensor(x)


def is_sparse_coo(x):
    return isinstance(x, SparseCooTensor)


def is_sparse_csr(x):
    return isinstance(x, SparseCsrTensor)


def _coo(x):
    if isinstance(x, SparseCsrTensor):
        return x.to_sparse_coo()
    if not isinstance(x, SparseCooTensor):
        raise TypeError(f"expected a sparse tensor, got {type(x)}")
    return x


def _coalesce(indices, values, shape):
    strides = torch.tensor(
        [int(torch.tensor(shape[i + 1:]).prod()) for i in range(len(shape))],
        device=indices.device, dtype=torch.int64)
    lin = (indices * strides[:, None]).sum(dim=0)
    uniq, inverse = torch.unique(lin, sorted=True, return_inverse=True)
    vals = values.new_zeros((uniq.numel(),) + tuple(values.shape[1:]))
    vals = vals.index_add(0, inverse, values)
    idx = torch.stack([(uniq // s) % n for s, n in zip(strides.tolist(),
                                                        shape)])
    return idx, vals


def _unary(torch_fn, name):
    def op(x, *args, **kwargs):
        x = _coo(x)
        return SparseCooTensor(x._indices, torch_fn(x._values, *args,
                                                    **kwargs), x._shape)

    op.__name__ = op.__qualname__ = name
    op.__doc__ = (f"paddle.sparse.{name}: applied to the stored values "
                  f"(a zero-preserving op: zeros stay implicit).")
    return op


relu = _unary(torch.relu, "relu")
sin = _unary(torch.sin, "sin")
tanh = _unary(torch.tanh, "tanh")
abs = _unary(torch.abs, "abs")  # noqa: A001  (the reference's name)
sqrt = _unary(torch.sqrt, "sqrt")
square = _unary(torch.square, "square")
neg = _unary(torch.neg, "neg")
pow = _unary(torch.pow, "pow")  # noqa: A001  (the reference's name)


def add(x, y):
    """sparse + sparse -> sparse: the union of the patterns, duplicates
    summed (coalesced)."""
    x, y = _coo(x), _coo(y)
    if x._shape != y._shape:
        raise ValueError(f"shape mismatch: {x._shape} vs {y._shape}")
    idx, vals = _coalesce(torch.cat([x._indices, y._indices], dim=1),
                          torch.cat([x._values, y._values]), x._shape)
    return SparseCooTensor(idx, vals, x._shape)


def multiply(x, y):
    """sparse * scalar, or sparse * dense sampled at the sparse pattern."""
    x = _coo(x)
    if isinstance(y, (builtins.int, builtins.float)):
        return SparseCooTensor(x._indices, x._values * y, x._shape)
    y = ensure_tensor(y)
    return SparseCooTensor(x._indices, x._values * y[tuple(x._indices)],
                           x._shape)


def matmul(x, y):
    """sparse (M, K) @ dense (K, N) or (K,) -> dense: each stored value
    scales its column's row of ``y`` and the products are summed into
    their rows."""
    x = _coo(x)
    y = ensure_tensor(y)
    if len(x._shape) != 2:
        raise ValueError(f"sparse.matmul takes a 2-D sparse matrix, got "
                         f"shape {x._shape}")
    vec = y.dim() == 1
    dense = y[:, None] if vec else y
    rows, cols = x._indices
    prod = x._values[:, None].to(dense.dtype) * dense[cols]
    out = dense.new_zeros((x._shape[0], dense.shape[1])).index_add(
        0, rows, prod)
    return out[:, 0] if vec else out


def masked_matmul(x, y, mask):
    """(dense @ dense) sampled at ``mask``'s pattern (SDDMM): a
    :class:`SparseCooTensor` of ``x[r] . y[:, c]`` for each stored
    (r, c)."""
    x, y = ensure_tensor(x), ensure_tensor(y)
    mask = _coo(mask)
    rows, cols = mask._indices
    vals = (x[rows] * y[:, cols].t()).sum(dim=-1)
    return SparseCooTensor(mask._indices, vals, mask._shape)
