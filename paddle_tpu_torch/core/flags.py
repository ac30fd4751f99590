"""FLAGS registry: the reference's (``paddle_tpu/core/flags.py``), a
plain registry with an environment override at definition; unknown flags
may be set, so code that sets vendor flags does not fail."""
from __future__ import annotations

import os
from typing import Any

__all__ = ["define_flag", "set_flags", "get_flags"]

_FLAGS: dict[str, Any] = {}
_HELP: dict[str, str] = {}


def _coerce(value, like):
    if isinstance(like, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(like, int):
        return int(value)
    if isinstance(like, float):
        return float(value)
    return value


def _key(name):
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def define_flag(name: str, default, help: str = ""):
    """Register a flag; an environment variable of the same name wins over
    the default."""
    name = _key(name)
    value = default
    if name in os.environ:
        value = _coerce(os.environ[name], default)
    _FLAGS[name] = value
    _HELP[name] = help
    return value


def set_flags(flags: dict):
    """paddle.set_flags({'FLAGS_...': value})."""
    for k, v in flags.items():
        k = _key(k)
        if _FLAGS.get(k) is not None:
            v = _coerce(v, _FLAGS[k])
        _FLAGS[k] = v


def get_flags(flags) -> dict:
    """paddle.get_flags('FLAGS_x') or (['FLAGS_x', ...])."""
    if isinstance(flags, str):
        flags = [flags]
    return {_key(k): _FLAGS.get(_key(k)) for k in flags}


define_flag("FLAGS_check_nan_inf", False, "accepted; not checked per op")
define_flag("FLAGS_eager_delete_tensor_gb", 0.0, "accepted for compat")
define_flag("FLAGS_use_pallas_kernels", True,
            "accepted; the port's kernels run wherever a tensor is on CUDA")
define_flag("FLAGS_pallas_force", False, "accepted for compat")
define_flag("FLAGS_allocator_strategy", "auto_growth", "accepted for compat")
define_flag("FLAGS_cudnn_deterministic", False, "accepted for compat")
define_flag("FLAGS_embedding_deterministic", False, "accepted for compat")
