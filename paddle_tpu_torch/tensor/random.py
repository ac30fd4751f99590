"""Random ops (the reference's ``paddle_tpu/tensor/random.py``) drawing
from torch's generators on their tensor's device: after ``seed(s)`` a
sequence of draws repeats. The draws are torch's (Philox on the card, the
Mersenne twister on the CPU), not the reference's threefry."""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from .._device import resolve_device
from ._helpers import default_float, ensure_tensor, shape_arg, to_torch_dtype

__all__ = [
    "rand", "randn", "randint", "randint_like", "uniform", "uniform_",
    "normal", "normal_", "standard_normal", "randperm", "multinomial",
    "bernoulli", "poisson", "exponential_", "rand_like", "randn_like",
    "gumbel_softmax",
]



def _fdt(dtype):
    return to_torch_dtype(dtype) if dtype is not None else default_float()


def rand(shape, dtype=None, name=None):
    return torch.rand(shape_arg(shape), dtype=_fdt(dtype),
                      device=resolve_device())


def randn(shape, dtype=None, name=None):
    return torch.randn(shape_arg(shape), dtype=_fdt(dtype),
                       device=resolve_device())


standard_normal = randn


def rand_like(x, dtype=None, name=None):
    x = ensure_tensor(x)
    return torch.rand_like(x, dtype=to_torch_dtype(dtype) or x.dtype)


def randn_like(x, dtype=None, name=None):
    x = ensure_tensor(x)
    return torch.randn_like(x, dtype=to_torch_dtype(dtype) or x.dtype)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), shape_arg(shape),
                         dtype=to_torch_dtype(dtype), device=resolve_device())


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = ensure_tensor(x)
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape),
                         dtype=to_torch_dtype(dtype) or x.dtype,
                         device=x.device)


def _generator(seed, device):
    return (torch.Generator(device=device).manual_seed(int(seed)) if seed
            else None)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    """U[min, max); a nonzero ``seed`` draws from its own generator."""
    dev = resolve_device()
    out = torch.empty(shape_arg(shape), dtype=_fdt(dtype), device=dev)
    return out.uniform_(float(min), float(max),
                        generator=_generator(seed, dev))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        return x.uniform_(float(min), float(max),
                          generator=_generator(seed, x.device))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """mean + std * N(0, 1); the shape is the tensor argument's when mean
    or std is a tensor, else ``shape``."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        z = torch.randn(ref.shape, dtype=default_float(), device=ref.device)
        return mean + std * z
    shp = shape_arg(shape if shape is not None else (1,))
    return mean + std * torch.randn(shp, dtype=default_float(),
                                    device=resolve_device())


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(float(mean), float(std))


def randperm(n, dtype="int64", name=None):
    return torch.randperm(int(n), dtype=to_torch_dtype(dtype),
                          device=resolve_device())


def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(ensure_tensor(x), num_samples,
                             replacement=replacement)


def bernoulli(x, name=None):
    return torch.bernoulli(ensure_tensor(x))


def poisson(x, name=None):
    return torch.poisson(ensure_tensor(x))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(float(lam))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    return _F.gumbel_softmax(ensure_tensor(x), tau=temperature, hard=hard,
                             dim=axis)
