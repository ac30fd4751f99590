"""Device placement for the port's entry points.

Every entry point (``LlamaForCausalLM``, ``ServingEngine``,
``create_serving_engine``) runs on the GPU unless the caller passes
``device="cpu"``. Nothing is chosen by probing: asking for the default
device on a machine without CUDA raises instead of running on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raises when CUDA is not available for a
    CUDA device (the default included)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
