"""Places on torch devices.

The reference's accelerator place is ``TPUPlace`` and ``set_device('tpu')``
selects it (``paddle_tpu/core/place.py``). Here the accelerator is the
CUDA device: ``CUDAPlace`` is its place, and ``TPUPlace`` and ``XPUPlace``
name the same device, so code written for the reference runs on the card.
The current place decides the device of every entry point that is not
given one (``_device.resolve_device``): ``cuda`` until ``set_device``
says otherwise. Nothing is probed and nothing falls back: without CUDA the
default raises, and ``set_device("cpu")`` or ``place=CPUPlace()`` is how a
caller asks for the CPU.
"""
from __future__ import annotations

import torch

__all__ = [
    "Place", "CPUPlace", "CUDAPlace", "TPUPlace", "XPUPlace", "CustomPlace",
    "set_device", "get_device", "current_place", "device_for_place",
    "is_compiled_with_cuda", "is_compiled_with_rocm", "is_compiled_with_xpu",
    "is_compiled_with_custom_device",
]


class Place:
    """A named device slot (device_type, device_id)."""

    device_type = "undefined"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_tpu_place(self):
        """True for the accelerator place (``TPUPlace`` is the card here)."""
        return self.device_type == "gpu"


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace(Place):
    device_type = "gpu"


class TPUPlace(CUDAPlace):
    """The reference's accelerator place; here the CUDA device."""


class XPUPlace(CUDAPlace):
    pass


class CustomPlace(Place):
    def __init__(self, device_type: str, device_id: int = 0):
        super().__init__(device_id)
        self.device_type = device_type


_current: Place | None = None


def set_device(device) -> Place:
    """paddle.set_device('gpu' | 'gpu:1' | 'cpu' | 'tpu' | a Place).
    'tpu', 'xpu' and 'cuda' name the CUDA device."""
    global _current
    if isinstance(device, Place):
        _current = device
        return device
    name = str(device)
    kind, _, idx = name.partition(":")
    idx = int(idx) if idx else 0
    kind = {"tpu": "gpu", "xpu": "gpu", "cuda": "gpu"}.get(kind, kind)
    if kind == "cpu":
        _current = CPUPlace()
    elif kind == "gpu":
        _current = CUDAPlace(idx)
    else:
        _current = CustomPlace(kind, idx)
    return _current


def get_device() -> str:
    """'cpu' or 'gpu:<id>' (the reference says 'tpu:<id>')."""
    p = current_place()
    return "cpu" if p.is_cpu_place() else f"{p.device_type}:{p.device_id}"


def current_place() -> Place:
    return _current if _current is not None else CUDAPlace(0)


def device_for_place(place=None) -> torch.device:
    """A Place (``None``: the current one) -> its torch device. The default
    place, never set, is ``cuda``: the current CUDA device, which a
    launched rank has set to its own."""
    if place is None:
        if _current is None:
            return torch.device("cuda")
        place = _current
    if isinstance(place, (str, torch.device)):
        dev = torch.device(place)
        return dev
    if place.is_cpu_place():
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        return torch.device("cuda", place.device_id)
    raise ValueError(f"no torch device for {place}")


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_custom_device(device_type: str) -> bool:
    return False
