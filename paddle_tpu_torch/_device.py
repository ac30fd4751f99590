"""Device placement for the port's entry points.

Every entry point (``LlamaForCausalLM``, ``ServingEngine``,
``create_serving_engine``, ``to_tensor`` and the creation ops) runs on the
device of the current place (``core.place``), which is ``cuda`` unless
``set_device`` said otherwise, and a caller may pass ``device="cpu"`` (or
a place). Nothing is chosen by probing: asking for a CUDA device on a
machine without CUDA raises instead of running on the CPU.
"""
from __future__ import annotations

import torch

from .core.place import Place, device_for_place

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the current place's device (``cuda`` by default); a
    place, a string or a torch device names one. Raises when CUDA is not
    available for a CUDA device (the default included)."""
    if device is None or isinstance(device, Place):
        dev = device_for_place(device)
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or call set_device('cpu')) to "
            "run the plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
