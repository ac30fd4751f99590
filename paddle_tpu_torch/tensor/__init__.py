"""The op corpus (the reference's ``paddle_tpu/tensor``) on torch, and
paddle's tensor methods.

The reference attaches its op functions to its own ``Tensor`` where the
name is absent (``paddle_tpu/tensor/__init__.py``). Here the tensor is
``torch.Tensor``, and the same rule holds: a paddle name is attached only
where torch has none, so nothing of torch's is replaced. Where paddle and
torch mean different things by one name (``shape``, ``size``, ``numel``,
``T``, the operators), torch's meaning stays. No subclass and no
``__torch_function__``: the models, the engine and the captured graphs
keep plain tensors.
"""
from __future__ import annotations

import torch

from . import (creation, extras, linalg, logic, manipulation, math, random,
               search, stat)
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from ..core.dtype import to_torch_dtype
from ..core.place import CPUPlace, CUDAPlace

__all__ = sorted(set().union(*(m.__all__ for m in (
    creation, extras, linalg, logic, manipulation, math, random, search,
    stat))) - {"cholesky_fn", "to_jax_dtype"})

# the reference's names that stay functions only (creation from shapes,
# namespace helpers)
_SKIP = {"to_tensor", "is_tensor", "meshgrid", "tril_indices",
         "triu_indices", "broadcast_shape", "add_n", "shape", "rank",
         "rand", "randn", "randint", "uniform", "normal", "randperm",
         "arange", "linspace", "logspace", "eye", "zeros", "ones", "full",
         "empty", "complex", "polar", "assign", "broadcast_tensors",
         "cholesky_fn", "to_jax_dtype"}
_METHOD_SOURCES = [math, creation, manipulation, linalg, logic, random,
                   search, stat, extras]


def _place(self):
    return CPUPlace() if self.device.type == "cpu" else \
        CUDAPlace(self.device.index or 0)


def _get_stop_gradient(self):
    return not self.requires_grad


def _set_stop_gradient(self, v):
    if v and not self.is_leaf:
        self.detach_()
    else:
        self.requires_grad_(not bool(v))


def _get_trainable(self):
    return self.requires_grad


def _set_trainable(self, v):
    self.requires_grad_(bool(v))


def _clear_grad(self):
    self.grad = None


def _zero_grad(self):
    if self.grad is not None:
        self.grad.zero_()


def _retain_grads(self):
    self.retain_grad()


def _astype(self, dtype):
    return self.to(to_torch_dtype(dtype))


def _set_value(self, value):
    """Write ``value`` (a tensor, array or number) into this tensor in
    place; shapes must match."""
    v = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)
    if tuple(v.shape) != tuple(self.shape):
        raise ValueError(
            f"set_value shape mismatch: {tuple(v.shape)} vs "
            f"{tuple(self.shape)}")
    with torch.no_grad():
        self.copy_(v)
    return self


def _get_tensor(self):
    return self


_CORE = {
    "place": property(_place),
    "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
    "trainable": property(_get_trainable, _set_trainable),
    "is_tensor": property(lambda self: True),
    "clear_grad": _clear_grad,
    "clear_gradient": _clear_grad,
    "zero_grad": _zero_grad,
    "retain_grads": _retain_grads,
    "astype": _astype,
    "cast": _astype,
    "set_value": _set_value,
    "get_tensor": _get_tensor,
}


def _inplace(fn):
    def op(self, *args, **kwargs):
        with torch.no_grad():
            return self.copy_(fn(self, *args, **kwargs))

    op.__name__ = fn.__name__ + "_"
    return op


_INPLACE = {"scale_": math.scale}

ATTACHED = []


def _attach(name, value):
    if not hasattr(torch.Tensor, name):
        setattr(torch.Tensor, name, value)
        ATTACHED.append(name)


for _name, _value in _CORE.items():
    _attach(_name, _value)
for _mod in _METHOD_SOURCES:
    for _name in _mod.__all__:
        if _name not in _SKIP:
            _attach(_name, getattr(_mod, _name))
for _name, _fn in _INPLACE.items():
    _attach(_name, _inplace(_fn))
del _name, _value, _mod, _fn
