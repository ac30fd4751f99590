"""Weight carry between the reference and the port.

The reference's ``state_dict()`` (read through numpy, e.g.
``{k: v.numpy() for k, v in ref.state_dict().items()}``) has the same keys
as the port's parameters. Paddle's ``Linear`` keeps its weight as
(in, out) and ``torch.nn.Linear`` as (out, in): the carry transposes each
Linear weight once and copies everything else as it is.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_paddle_tpu_arrays"]


def _params(model):
    """key -> (parameter, is a Linear weight) in registration order."""
    out = {}
    for name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            key = f"{name}.{pname}" if name else pname
            out[key] = (p, isinstance(mod, nn.Linear) and pname == "weight")
    return out


def load_paddle_tpu_arrays(model, arrays):
    """Copy the reference's arrays into ``model``'s parameters (onto the
    model's device and dtype). Raises on a missing or extra key and on a
    shape that does not match. Returns the model."""
    params = _params(model)
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(
            f"reference arrays do not match the port's parameters: "
            f"missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for key, (p, transpose) in params.items():
            a = np.asarray(arrays[key])
            if transpose:
                a = a.T
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(
                    f"{key}: reference shape {tuple(np.asarray(arrays[key]).shape)}"
                    f" does not carry onto {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))
    return model
