"""``Layer`` and ``ParamAttr`` (the reference's
``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module`` that adds only the names ``Module``
lacks: ``create_parameter``, ``add_parameter``, ``add_sublayer``,
``sublayers``, ``named_sublayers``, ``set_state_dict``, ``full_name``,
``clear_gradients``, ``register_forward_post_hook``, ``astype``. Every
name ``Module`` has keeps torch's meaning (``parameters``, ``to``,
``register_buffer``'s ``persistent``, assignment to a parameter's name).
It keeps no state of its own beyond a name scope and a default dtype, so
a module rebased onto it keeps its parameters, buffers and launches. A
parameter's paddle name is its ``param_name`` (torch's ``name`` is a
read-only attribute of every tensor).
"""
from __future__ import annotations

import re

import torch

from ..._device import resolve_device
from ...core.dtype import get_default_dtype, to_torch_dtype
from .. import initializer as init_mod

__all__ = ["Layer", "ParamAttr"]


class ParamAttr:
    """paddle.ParamAttr: a parameter's name, initializer, learning rate,
    regularizer, trainability and clipping."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


_layer_counters: dict[str, int] = {}


def _unique_name(prefix: str) -> str:
    idx = _layer_counters.get(prefix, 0)
    _layer_counters[prefix] = idx + 1
    return f"{prefix}_{idx}"


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._paddle_name_scope = name_scope
        self._paddle_dtype = dtype

    def full_name(self):
        """A unique name from the name scope (or the class name in snake
        case), made at the first call: ``linear_0``."""
        name = self.__dict__.get("_paddle_full_name")
        if name is None:
            scope = (getattr(self, "_paddle_name_scope", None)
                     or re.sub(r"(?<!^)(?=[A-Z])", "_",
                               type(self).__name__).lower())
            name = self.__dict__["_paddle_full_name"] = _unique_name(scope)
        return name

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new parameter (the caller assigns it to register it) on the
        current place's device, in ``dtype`` (the layer's, else the
        default): ``attr``'s initializer, else ``default_initializer``,
        else zeros for a bias and Xavier-normal for a weight (the
        reference's defaults). ``attr=False`` returns None."""
        if attr is False:
            return None
        dtype = to_torch_dtype(dtype or getattr(self, "_paddle_dtype", None)
                               or get_default_dtype())
        attr = attr if isinstance(attr, ParamAttr) else None
        initializer = (attr.initializer if attr is not None else None) \
            or default_initializer or (
                init_mod.Constant(0.0) if is_bias else init_mod.XavierNormal())
        value = initializer([int(s) for s in shape], dtype,
                            resolve_device(None))
        p = torch.nn.Parameter(value, requires_grad=(
            attr.trainable if attr is not None else True))
        idx = self.__dict__.get("_param_name_counter", 0)
        self.__dict__["_param_name_counter"] = idx + 1
        p.param_name = (attr.name if attr is not None and attr.name else
                        f"{self.full_name()}.{'b' if is_bias else 'w'}_{idx}")
        p.optimize_attr = {"learning_rate": attr.learning_rate
                           if attr is not None else 1.0}
        p.regularizer = attr.regularizer if attr is not None else None
        p.need_clip = attr.need_clip if attr is not None else True
        p.is_bias = is_bias
        return p

    def create_variable(self, name=None, persistable=False, dtype=None):
        return torch.zeros((), dtype=to_torch_dtype(
            dtype or getattr(self, "_paddle_dtype", None)
            or get_default_dtype()), device=resolve_device(None))

    def add_parameter(self, name, parameter):
        self.register_parameter(str(name), parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def sublayers(self, include_self=False):
        return [m for m in self.modules() if include_self or m is not self]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if include_self or m is not self:
                yield name, m

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy matching entries in (shapes must match); returns (missing,
        unexpected) keys, as the reference does."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for key, value in state_dict.items():
                if key not in own:
                    continue
                target = own[key]
                v = torch.as_tensor(
                    value.detach() if isinstance(value, torch.Tensor)
                    else value)
                if tuple(v.shape) != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: loaded {tuple(v.shape)}"
                        f" vs param {tuple(target.shape)}")
                target.copy_(v)
        return missing, unexpected

    load_dict = set_state_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``, torch's forward hook."""
        return self.register_forward_hook(hook)

    def astype(self, dtype):
        dt = to_torch_dtype(dtype)
        for t in list(self.parameters()) + list(self.buffers()):
            if t.is_floating_point():
                t.data = t.data.to(dt)
        return self
