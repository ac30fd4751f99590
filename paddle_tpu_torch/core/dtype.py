"""Paddle's dtype surface on torch dtypes.

The reference wraps numpy dtypes in a ``DType`` class that prints the
paddle way (``paddle_tpu/core/dtype.py``). Here the dtype objects are
torch's own: ``float32`` is ``torch.float32``, ``DType`` is
``torch.dtype``, and ``dtype(d)`` coerces a name, an alias, a numpy dtype
or a python type to one. This module is the port's one string-to-dtype
table.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DType", "dtype", "to_torch_dtype", "one_of", "get_default_dtype",
    "set_default_dtype", "finfo", "iinfo", "bfloat16", "float16", "float32",
    "float64", "int8", "int16", "int32", "int64", "uint8", "uint16",
    "uint32", "uint64", "bool_", "complex64", "complex128", "float8_e4m3fn",
    "float8_e5m2",
]

DType = torch.dtype

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
uint64 = torch.uint64
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_BY_NAME = {
    "bfloat16": bfloat16, "float16": float16, "float32": float32,
    "float64": float64, "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "uint8": uint8, "uint16": uint16, "uint32": uint32,
    "uint64": uint64, "bool": bool_, "complex64": complex64,
    "complex128": complex128, "float8_e4m3fn": float8_e4m3fn,
    "float8_e5m2": float8_e5m2,
}
# paddle accepts these spellings too (the reference's aliases, and
# "half", which numpy reads as float16)
_ALIASES = {"fp32": "float32", "fp16": "float16", "bf16": "bfloat16",
            "fp64": "float64", "half": "float16"}
_NAME_OF = {v: k for k, v in _BY_NAME.items()}


def to_torch_dtype(d):
    """A dtype name, alias, torch / numpy dtype or python type -> the torch
    dtype (``None`` passes through). Raises ``TypeError`` for anything
    else."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        name = d[len("paddle."):] if d.startswith("paddle.") else d
        name = _ALIASES.get(name, name)
        if name in _BY_NAME:
            return _BY_NAME[name]
        raise TypeError(f"unknown dtype {d!r}")
    if d is float:
        return float32
    if d is int:
        return int64
    if d is bool:
        return bool_
    try:
        name = np.dtype(d).name
    except TypeError:
        raise TypeError(f"cannot interpret {d!r} as a dtype") from None
    if name not in _BY_NAME:
        raise TypeError(f"unsupported dtype {d!r}")
    return _BY_NAME[name]


def one_of(d, allowed):
    """``d`` as a torch dtype if it is one of ``allowed``, else None (an
    unknown name included)."""
    try:
        dt = to_torch_dtype(d)
    except TypeError:
        return None
    return dt if dt in allowed else None


def dtype(d):
    """paddle.dtype: coerce to a torch dtype."""
    return to_torch_dtype(d)


_default = float32


def get_default_dtype() -> str:
    """The default float dtype's name, as paddle returns it. It decides
    what python floats become in ``to_tensor`` and the creation ops; torch's
    own default is left alone."""
    return _NAME_OF[_default]


def set_default_dtype(d):
    global _default
    d = to_torch_dtype(d)
    if not (d.is_floating_point or d.is_complex):
        raise TypeError(
            f"set_default_dtype only accepts floating dtypes, got {d}")
    _default = d


def default_float():
    return _default


def finfo(d):
    return torch.finfo(to_torch_dtype(d))


def iinfo(d):
    return torch.iinfo(to_torch_dtype(d))
