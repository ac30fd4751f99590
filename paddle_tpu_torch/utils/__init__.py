"""paddle.utils (the reference's ``paddle_tpu/utils``): the install check,
``try_import``, ``unique_name`` and the op registry's introspection."""
from __future__ import annotations

import importlib

__all__ = ["run_check", "try_import", "unique_name", "get_registered_ops",
           "get_op_callable"]


def run_check():
    """The install smoke test: a small matmul forward and backward on the
    current place's device."""
    import torch

    import paddle_tpu_torch as paddle

    dev = paddle.get_device()
    print(f"Running verify PaddlePaddle (PyTorch port) program on {dev} ...")
    g = torch.Generator().manual_seed(0)
    x = paddle.to_tensor(torch.rand(16, 32, generator=g),
                         stop_gradient=False)
    w = paddle.to_tensor(torch.rand(32, 8, generator=g), stop_gradient=False)
    (x @ w).sum().backward()
    if x.grad is None or w.grad is None:
        raise RuntimeError("run_check: no gradient reached the inputs")
    print("PaddlePaddle (PyTorch port) is installed successfully!")


def try_import(module_name, err_msg=None):
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f"{module_name} is required but not installed") from e


class _UniqueNames:
    def __init__(self):
        self._counters = {}

    def generate(self, key="tmp"):
        i = self._counters.get(key, 0)
        self._counters[key] = i + 1
        return f"{key}_{i}"


unique_name = _UniqueNames()


def get_registered_ops():
    """The registry's names and every op name ``apply`` has run, sorted."""
    from ..core.dispatch import OP_REGISTRY, SEAM_OPS

    return sorted(set(OP_REGISTRY) | SEAM_OPS)


def get_op_callable(name):
    """The callable registered for ``name`` (KeyError if absent)."""
    from ..core.dispatch import OP_REGISTRY

    return OP_REGISTRY[name]
