"""Weight carry between the reference and the port.

The reference's ``state_dict()`` (read through numpy, e.g.
``{k: v.numpy() for k, v in ref.state_dict().items()}``) has the same keys
as the port's parameters. Paddle's ``Linear`` keeps its weight as
(in, out) and ``torch.nn.Linear`` as (out, in): the carry transposes each
Linear weight once and copies everything else as it is. A quantized
model's int8 ``quant_weight`` (``QuantizedLinear``) is transposed the same
way; its ``weight_scale`` is per output channel and carries as it is.
The GPT's blocks are the ModuleList ``gpt.h``, so the reference's
``gpt.h.{i}...`` keys land on them. The stacked raw parameters of
``FusedMultiTransformer`` ((L, in, out), int8 after
``quantize_weight_only`` with their (L, out) scales) and ``MoELayer``
((E, in, out) and the (d_model, E) gate) are no Linear weights and carry
as they are. Persistent buffers travel too, as they are (BatchNorm's
``_mean`` and ``_variance`` running statistics, keyed as the
reference's); conv weights are no Linear weights and carry untransposed.

Under the hybrid mesh a rank holds slices: the carry takes the
reference's full arrays all the same and each rank loads its part, the
tensor-parallel slice (``_mp_split``) and then its stage-3 chunk
(``group_sharded.carry_local``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..distributed.fleet.layers.mpu.mp_layers import full_shape
from ..distributed.fleet.meta_parallel.sharding.group_sharded import (
    carry_local)
from ..nn.quant import QuantizedLinear

__all__ = ["load_paddle_tpu_arrays", "paddle_tpu_arrays_to_port"]


def _params(model):
    """key -> (parameter or persistent buffer, is a Linear weight) in
    registration order."""
    out = {}
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        for pname, p in mod.named_parameters(recurse=False):
            out[prefix + pname] = (
                p, (isinstance(mod, nn.Linear) and pname == "weight")
                or (isinstance(mod, QuantizedLinear)
                    and pname == "quant_weight"))
        for bname, b in mod.named_buffers(recurse=False):
            if bname not in mod._non_persistent_buffers_set:
                out[prefix + bname] = (b, False)
    return out


def paddle_tpu_arrays_to_port(model, arrays, subset=False):
    """The reference's arrays in ``model``'s layout, without loading them:
    ``key -> numpy array`` with the keys and transposes of
    :func:`load_paddle_tpu_arrays` (each Linear weight transposed). Raises
    on a missing or extra key and on a shape that does not match. Use it
    to hold the reference's gradients, updated parameters or running
    statistics against the port's. The arrays are full ones: a rank's
    slice of a parallel parameter is ``carry_local(param, array)``. With
    ``subset`` the model may hold fewer keys than ``arrays`` (a pipeline
    stage's layers); every key it holds must be there."""
    params = _params(model)
    missing = sorted(set(params) - set(arrays))
    extra = [] if subset else sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(
            f"reference arrays do not match the port's parameters: "
            f"missing {missing}, unexpected {extra}")
    out = {}
    for key, (p, transpose) in params.items():
        a = np.asarray(arrays[key])
        if transpose:
            a = a.T
        if tuple(a.shape) != full_shape(p):
            raise ValueError(
                f"{key}: reference shape {tuple(np.asarray(arrays[key]).shape)}"
                f" does not carry onto {tuple(p.shape)}")
        out[key] = a
    return out


def load_paddle_tpu_arrays(model, arrays, subset=False):
    """Copy the reference's arrays into ``model``'s parameters and
    persistent buffers (onto the model's device and their dtypes). Raises on a missing or extra key and on a
    shape that does not match. Returns the model."""
    ported = paddle_tpu_arrays_to_port(model, arrays, subset)
    params = _params(model)
    with torch.no_grad():
        for key, a in ported.items():
            p = params[key][0]
            local = carry_local(p, torch.from_numpy(np.array(a)))
            p.copy_(local.to(p.dtype))
    return model
