"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``: ``rms_norm`` and ``layer_norm``)."""
from __future__ import annotations

import torch

from ... import amp
from ...amp import amp_state
from ...ops.rms_norm import RMSNormFunction

__all__ = ["rms_norm", "layer_norm"]


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """RMSNorm over dims ``[begin_norm_axis:]``, the hot norm of
    Llama-family models (op name ``rms_norm``, black-listed by amp). With a
    weight and no bias the normalized dims are flattened into one feature
    axis and go through :class:`RMSNormFunction`: K1 forward and K6
    backward on CUDA tensors, their plain versions on CPU tensors; a
    kernel failure raises. Without a weight, or with a bias, it computes
    the reference's XLA formula, which is where the reference sends these
    variants too: ``x * rsqrt(mean(x^2) + eps)`` in f32, rounded to x's
    dtype, then times the weight and plus the bias (promoting)."""
    if amp_state.enabled:
        x, weight, bias = amp.cast_inputs_for_op("rms_norm", x, weight, bias)
    axis0 = begin_norm_axis % x.dim()
    lead = x.shape[:axis0]
    if weight is not None and bias is None:
        out = RMSNormFunction.apply(x.reshape(*lead, -1), weight.reshape(-1),
                                    epsilon)
        return out.reshape(x.shape)
    dims = tuple(range(axis0, x.dim()))
    var = x.float().square().mean(dim=dims, keepdim=True)
    out = (x.float() * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(x.shape[axis0:])
    if bias is not None:
        out = out + bias.reshape(x.shape[axis0:])
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` dims (op name
    ``layer_norm``, black-listed by amp). The reference runs it through
    XLA with no Pallas kernel, and so does the port through PyTorch's own
    ``layer_norm``, in the reference's rounding order: ``(x - mean) *
    rsqrt(var + eps)`` in f32 (population variance), rounded to x's
    dtype, then times the weight and plus the bias (promoting, as in the
    reference: a bf16 x with an f32 weight gives f32)."""
    if amp_state.enabled:
        x, weight, bias = amp.cast_inputs_for_op("layer_norm", x, weight,
                                                 bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    shape = tuple(int(n) for n in normalized_shape)
    out = torch.nn.functional.layer_norm(x.float(), shape,
                                         eps=epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
