"""paddle.device (the reference's ``paddle_tpu/device``) on ``torch.cuda``:
device counts, synchronization, the caching allocator's memory statistics,
``empty_cache``, device properties, and ``Stream`` / ``Event`` as torch's
CUDA streams and events. ``cuda`` names the same functions
(``paddle.device.cuda.max_memory_allocated()``)."""
from __future__ import annotations

import types

import torch

from ..core.place import (CPUPlace, CUDAPlace, TPUPlace,  # noqa: F401
                          current_place, get_device, set_device)

__all__ = [
    "set_device", "get_device", "get_all_device_type",
    "get_available_device", "device_count", "synchronize",
    "memory_allocated", "max_memory_allocated", "memory_reserved",
    "max_memory_reserved", "empty_cache", "get_device_properties", "cuda",
    "Stream", "Event",
]


def _index(device=None):
    """paddle's device argument -> a CUDA index: None (the current place's
    or device 0), an int, 'gpu:1', or a place."""
    if device is None:
        p = current_place()
        return p.device_id if isinstance(p, CUDAPlace) else 0
    if isinstance(device, int):
        return device
    did = getattr(device, "device_id", None)
    if did is not None:
        return int(did)
    name = str(device)
    return int(name.rsplit(":", 1)[1]) if ":" in name else 0


def get_all_device_type():
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_available_device():
    return [f"gpu:{i}" for i in range(device_count())]


def device_count(device_type=None):
    if device_type not in (None, "gpu", "cuda"):
        return 0
    return torch.cuda.device_count()


def synchronize(device=None):
    """Wait for all work on the CUDA device."""
    torch.cuda.synchronize(_index(device))


def memory_allocated(device=None):
    return int(torch.cuda.memory_allocated(_index(device)))


def max_memory_allocated(device=None):
    return int(torch.cuda.max_memory_allocated(_index(device)))


def memory_reserved(device=None):
    return int(torch.cuda.memory_reserved(_index(device)))


def max_memory_reserved(device=None):
    return int(torch.cuda.max_memory_reserved(_index(device)))


def empty_cache():
    """Return the caching allocator's unused blocks to the driver."""
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def get_device_properties(device=None):
    p = torch.cuda.get_device_properties(_index(device))
    return types.SimpleNamespace(
        name=p.name, total_memory=int(p.total_memory), major=p.major,
        minor=p.minor, multi_processor_count=p.multi_processor_count)


class Stream(torch.cuda.Stream):
    """paddle.device.Stream: a CUDA stream on ``device`` (paddle's
    priority 2 is the normal one)."""

    def __new__(cls, device=None, priority=2):
        return super().__new__(cls, device=_index(device),
                               priority=0 if priority == 2 else -1)

    def __init__(self, device=None, priority=2):
        pass


class Event(torch.cuda.Event):
    """paddle.device.Event: a CUDA event."""

    def __new__(cls, enable_timing=False, blocking=False,
                interprocess=False):
        return super().__new__(cls, enable_timing=enable_timing,
                               blocking=blocking, interprocess=interprocess)

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        pass


cuda = types.SimpleNamespace(
    device_count=device_count, memory_allocated=memory_allocated,
    max_memory_allocated=max_memory_allocated,
    memory_reserved=memory_reserved,
    max_memory_reserved=max_memory_reserved, empty_cache=empty_cache,
    synchronize=synchronize, get_device_properties=get_device_properties,
    Stream=Stream, Event=Event)
