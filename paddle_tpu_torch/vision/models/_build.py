"""How the vision models are built: each constructs its layers under
``with device:`` (``resolve_device``: default ``cuda``; raises without
CUDA unless ``device="cpu"``), then :func:`seed_weights` draws them
from ``generator`` (a ``torch.Generator`` on that device; seed 0 when
omitted) by the reference's initializers: conv weights and biases
``Uniform(-k, k)`` with ``k = 1 / sqrt(fan_in)``, ``Linear`` weights
Xavier-normal and biases 0, norm weights 1 and biases 0. The draws are
PyTorch's, not the reference's: the tests carry the reference's weights
across (``vision.convert``)."""
from __future__ import annotations

import math

import torch

from ...nn.layer.conv import _ConvNd

__all__ = ["seed_weights"]


def seed_weights(model, dev, generator=None):
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _ConvNd):
                m.reset_parameters(generator)
            elif isinstance(m, torch.nn.Linear):
                std = math.sqrt(2.0 / (m.in_features + m.out_features))
                m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model
