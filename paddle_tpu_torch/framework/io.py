"""``paddle.save`` / ``paddle.load`` of the port (counterpart of
``paddle_tpu/framework/io.py``): a pickle of the object with every tensor
replaced by a payload of its CPU copy, so nested state dicts of a model's
tensors and Parameters and an optimizer's state round-trip. ``load``
gives CPU tensors (Parameters where a Parameter was saved, with its
``requires_grad``), or numpy arrays with ``return_numpy=True`` (bf16 /
fp16 come back as f32 arrays there, which numpy cannot hold otherwise).

The format is the port's own: a file the reference wrote holds its
``_TensorPayload`` objects, which unpickle only with ``paddle_tpu``
importable, so the port does not read them (ROADMAP queue C).
"""
from __future__ import annotations

import os
import pickle

import torch

__all__ = ["save", "load"]

_PROTOCOL = 4


class _TensorPayload:
    """A tensor's CPU copy and whether it was a Parameter."""

    def __init__(self, tensor, is_param):
        self.tensor = tensor
        self.is_param = is_param


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().clone()
        if isinstance(obj, torch.nn.Parameter):
            t.requires_grad_(obj.requires_grad)
        return _TensorPayload(t, isinstance(obj, torch.nn.Parameter))
    if isinstance(obj, dict):
        return type(obj)((k, _pack(v)) for k, v in obj.items())
    if isinstance(obj, list):
        return [_pack(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        t = obj.tensor
        if return_numpy:
            if t.dtype in (torch.bfloat16, torch.float16):
                t = t.float()
            return t.detach().numpy()
        if obj.is_param:
            return torch.nn.Parameter(t.detach(), requires_grad=t.requires_grad)
        return t
    if isinstance(obj, dict):
        return type(obj)((k, _unpack(v, return_numpy))
                         for k, v in obj.items())
    if isinstance(obj, list):
        return [_unpack(v, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=_PROTOCOL, **configs):
    """Write ``obj`` to ``path`` (a file name, whose directory is made,
    or a writable binary file)."""
    if isinstance(path, (str, os.PathLike)):
        d = os.path.dirname(os.fspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(_pack(obj), f, protocol=protocol)
    else:
        pickle.dump(_pack(obj), path, protocol=protocol)


def load(path, **configs):
    """Read what :func:`save` wrote; ``return_numpy=True`` gives numpy
    arrays for the tensors."""
    return_numpy = configs.get("return_numpy", False)
    if isinstance(path, (str, os.PathLike)):
        with open(path, "rb") as f:
            obj = pickle.load(f)
    else:
        obj = pickle.load(path)
    return _unpack(obj, return_numpy)
