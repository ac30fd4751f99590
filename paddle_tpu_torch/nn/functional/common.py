"""Products and lookups with amp's cast seam (counterpart of the
reference's ``linear`` in ``paddle_tpu/nn/functional/common.py`` and
``matmul`` in ``paddle_tpu/tensor/linalg.py``).

Inputs of one dtype take PyTorch's own product. Mixed dtypes (a bf16
base weight and f32 LoRA factors outside amp) follow the reference: the
product runs in the promoted dtype and, when the left operand is bf16 or
fp16, comes back in that dtype (the reference's f32-accumulated product
cast to the input's dtype); a bias is then added in the output's dtype.
"""
from __future__ import annotations

import torch

from ... import amp
from ...amp import amp_state

__all__ = ["linear", "matmul", "embedding", "dropout"]

_HALF = (torch.bfloat16, torch.float16)


def _mixed(op, x, y):
    """``op(x, y)`` of two floating tensors of different dtypes, the
    reference's way."""
    common = torch.promote_types(x.dtype, y.dtype)
    out = op(x.to(common), y.to(common))
    return out.to(x.dtype) if x.dtype in _HALF else out


def torch_linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with weight (out, in), torch's layout: the
    product of the port's ``Linear`` (op name ``linear``)."""
    if amp_state.enabled:
        x, weight, bias = amp.cast_inputs_for_op("linear", x, weight, bias)
    if x.dtype == weight.dtype and (bias is None or bias.dtype == x.dtype):
        return torch.nn.functional.linear(x, weight, bias)
    out = (_mixed(torch.nn.functional.linear, x, weight)
           if x.dtype != weight.dtype
           else torch.nn.functional.linear(x, weight))
    return out if bias is None else out + bias.to(out.dtype)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with weight (in, out), paddle's layout."""
    return torch_linear(x, weight.t(), bias)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``paddle.matmul``: ``x @ y``, either operand's last two dims swapped
    first on request."""
    if amp_state.enabled:
        x, y = amp.cast_inputs_for_op("matmul", x, y)
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    if x.dtype == y.dtype:
        return torch.matmul(x, y)
    return _mixed(torch.matmul, x, y)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows ``weight[x]`` (op name ``embedding``); ``padding_idx`` rows
    get no gradient."""
    if amp_state.enabled:
        (weight,) = amp.cast_inputs_for_op("embedding", weight)
    return torch.nn.functional.embedding(x, weight, padding_idx,
                                         sparse=sparse)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """``paddle.nn.functional.dropout``: in training, zero each element
    (or, with ``axis``, each slice along those axes) with probability
    ``p``, the keep mask drawn from ``generator`` (a ``torch.Generator``
    on x's device; the global one when omitted); ``upscale_in_train``
    divides the kept values by ``1 - p``. Outside training it is the
    identity, or a scale by ``1 - p`` under ``downscale_in_infer``. The
    draws are PyTorch's, not the reference's JAX keys."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unsupported dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in
                ((axis,) if isinstance(axis, int) else tuple(axis))}
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)
