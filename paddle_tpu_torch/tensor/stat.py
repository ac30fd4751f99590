"""Statistics ops (the reference's ``paddle_tpu/tensor/stat.py``)."""
from __future__ import annotations

import torch

from ._helpers import axes_arg, ensure_tensor
from .math import _float, mean  # noqa: F401  (paddle has mean here too)

__all__ = ["mean", "std", "var", "numel", "histogramdd"]


def _moment(fn):
    def op(x, axis=None, unbiased=True, keepdim=False, name=None):
        x = _float(ensure_tensor(x))
        ax = axes_arg(axis)
        return fn(x, dim=ax, correction=1 if unbiased else 0,
                  keepdim=keepdim)

    return op


var = _moment(torch.var)
std = _moment(torch.std)


def numel(x, name=None):
    """The element count as a 0-d int64 tensor."""
    x = ensure_tensor(x)
    return torch.as_tensor(x.numel(), dtype=torch.int64, device=x.device)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """(counts, [edges per dim]) of an (N, D) sample, integer counts unless
    weighted or ``density``; computed on the CPU (torch's histogramdd has
    no CUDA kernel) and moved back."""
    x = ensure_tensor(x)
    w = None if weights is None else ensure_tensor(weights, like=x)
    rng = None if ranges is None else [float(r) for r in ranges]
    h, edges = torch.histogramdd(
        x.detach().float().cpu(), bins=bins, range=rng, density=density,
        weight=None if w is None else w.float().cpu())
    if not density and w is None:
        h = h.to(torch.int64)
    return h.to(x.device), [e.to(x.device) for e in edges]
