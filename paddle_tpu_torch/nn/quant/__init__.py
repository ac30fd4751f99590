"""Quantization ops and layers (counterpart of ``paddle_tpu/nn/quant``).

Weight-only int8 serving: ``quantize_for_serving`` turns every
``torch.nn.Linear`` of a model (the q/k/v/o projections, the MLP and the
lm-head) into a :class:`QuantizedLinear` that keeps an int8 weight and
one f32 scale per output channel. Its forward dequantizes the weight in
the activation's dtype and runs ``F.linear`` over it, so a float Linear
holding the same dequantized matrix computes the same product bit for
bit: the equality oracle of the int8 serving engine. The int8 paged KV
pools store one abs-max scale per written row (:func:`quantize_kv_rows`).

Every quantizer matches the reference bit for bit: round half to even
(``torch.round``, as ``jnp.round``), division by the scale (never a
multiply by its reciprocal), and the reference's working dtypes (the
weight's own dtype for :func:`weight_quantize_stacked`, f32 for
:func:`quantize_kv_rows`).

:func:`weight_only_linear` takes the reference's ``(in, out)`` int8
weight, the layout :func:`weight_quantize` returns; ``QuantizedLinear``
keeps torch's ``(out, in)`` parameter. Its bias stays in the weight's
dtype, where the reference's is f32 (a biased bf16 layer returns bf16
here, f32 there): an f32 projection output would reach the attention
kernels beside bf16 KV pools, which they refuse (ROADMAP, queue C,
deliberate differences).

Not in the port yet: ``a8w8_linear`` and activation-quantized
``QuantizedLinear`` (ROADMAP A3: an int8 x int8 -> int32 product, as the
reference's ``dot_general`` with ``preferred_element_type=int32``), the
tensor-parallel ``QuantizedColumnParallelLinear`` /
``QuantizedRowParallelLinear`` (A7), and QAT/PTQ (A9).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF
from torch import nn

__all__ = [
    "fake_quantize_dequantize_abs_max",
    "quantize_linear", "dequantize_linear",
    "weight_quantize", "weight_dequantize", "weight_quantize_stacked",
    "weight_only_linear", "a8w8_linear",
    "QuantizedLinear",
    "QuantizedColumnParallelLinear", "QuantizedRowParallelLinear",
    "quantize_for_serving", "quantize_kv_rows",
]

_ALGOS = ("weight_only_int8", "llm.int8")


def fake_quantize_dequantize_abs_max(x, bits=8, name=None):
    """Per-tensor abs-max quant-dequant with a straight-through gradient
    (``x + (q - x).detach()``: the backward is the identity)."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp_min(x.detach().abs().max(), 1e-8) / qmax
    q = torch.clamp(torch.round(x.detach() / scale), -qmax - 1, qmax) * scale
    return x + (q - x).detach()


def _along(s, ndim, axis):
    if axis is not None and s.dim() == 1:
        shape = [1] * ndim
        shape[axis] = -1
        return s.reshape(shape)
    return s


def quantize_linear(x, scale, zero_point=0, bits=8, axis=None, name=None):
    """int8 ``clip(round(x / scale) + zero_point)``; a 1-D ``scale`` with
    ``axis`` is per channel along that axis."""
    qmax = 2 ** (bits - 1) - 1
    s = _along(torch.as_tensor(scale, device=x.device), x.dim(), axis)
    q = torch.clamp(torch.round(x / s) + zero_point, -qmax - 1, qmax)
    return q.to(torch.int8)


def dequantize_linear(x, scale, zero_point=0, axis=None, name=None):
    """``(x - zero_point) * scale`` in the scale's dtype."""
    s = _along(torch.as_tensor(scale, device=x.device), x.dim(), axis)
    return (x.to(s.dtype) - zero_point) * s


def weight_quantize_stacked(w, axis=1):
    """Per-channel int8 quantization of ``w``: the abs-max over ``axis``
    over 127 is the scale of each remaining index. The scale and ``w /
    scale`` are computed in ``w``'s own dtype (bf16 for a bf16 model) and
    the scale is cast to f32 only at the end, as the reference does.
    Returns ``(int8 w, f32 scale)``."""
    scale = torch.clamp_min(w.abs().amax(dim=axis), 1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale.unsqueeze(axis)), -128, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def weight_quantize(x, algo="weight_only_int8", name=None):
    """Per-output-channel int8 quantization of an ``(in, out)`` weight
    (the reference's layout). Returns ``(int8 (in, out), f32 (out,))``."""
    if algo not in _ALGOS:
        raise ValueError(f"unsupported weight quantize algo: {algo}")
    return weight_quantize_stacked(x, axis=0)


def weight_dequantize(x, scale, algo="weight_only_int8", name=None):
    """Float ``(in, out)`` weight from :func:`weight_quantize`'s pair."""
    return dequantize_linear(x, scale, axis=1)


def quantize_kv_rows(x):
    """Per-row symmetric int8 quantization of KV rows, in f32: the
    abs-max over the last (head) axis over 127. Returns ``(q, scale)``,
    ``q`` int8 shaped like ``x`` and ``scale`` f32 shaped
    ``x.shape[:-1]``. A row's scale depends only on its own values, so a
    sequence's quantized pool rows do not depend on how it was cut into
    prefill chunks and decode quanta."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -128, 127)
    return q.to(torch.int8), scale


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", name=None):
    """``y = x @ dequant(weight) + bias`` for an int8 ``(in, out)``
    weight (the reference's layout, as :func:`weight_quantize` returns
    it) and f32 per-output-channel ``(out,)`` scales. The weight
    dequantizes in ``x``'s dtype, the scale cast to it first
    (``wq.to(x.dtype) * ws.to(x.dtype)``), and the bias is added after
    the product, as the reference does."""
    if weight_scale is None:
        raise ValueError("weight_only_linear requires weight_scale")
    y = x @ (weight * weight_scale.to(x.dtype))
    return y if bias is None else y + bias


def _dequantized(wq, ws, dtype):
    # an (out, in) weight: one pass (int8 read, float written), the int8
    # operand promotes to ``dtype`` inside the multiply, exactly as
    # ``wq.to(dtype)`` would
    return wq * ws.to(dtype)[:, None]


def a8w8_linear(x, weight, x_scale, weight_scale, bias=None, name=None):
    raise NotImplementedError(
        "a8w8_linear is not ported yet (ROADMAP A3: an int8 x int8 -> "
        "int32 product)")


class QuantizedLinear(nn.Module):
    """Weight-only int8 Linear: ``quant_weight`` int8 ``(out, in)`` and
    ``weight_scale`` f32 ``(out,)``, both parameters without grad; the
    bias (if any) in the float weight's dtype."""

    def __init__(self, in_features, out_features, has_bias=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.quant_weight = nn.Parameter(
            torch.zeros(self.out_features, self.in_features,
                        dtype=torch.int8, device=device),
            requires_grad=False)
        self.weight_scale = nn.Parameter(
            torch.ones(self.out_features, dtype=torch.float32,
                       device=device), requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(self.out_features,
                                              dtype=dtype, device=device))
                     if has_bias else None)

    @staticmethod
    def from_linear(linear, act_scale=None):
        """The int8 counterpart of a float ``torch.nn.Linear``."""
        if act_scale is not None:
            raise NotImplementedError(
                "QuantizedLinear with an activation scale runs a8w8_linear, "
                "which is not ported yet (ROADMAP A3)")
        w = linear.weight.detach()
        out = QuantizedLinear(linear.in_features, linear.out_features,
                              has_bias=linear.bias is not None,
                              device=w.device, dtype=w.dtype)
        qw, scale = weight_quantize_stacked(w, axis=1)
        with torch.no_grad():
            out.quant_weight.copy_(qw)
            out.weight_scale.copy_(scale)
            if linear.bias is not None:
                out.bias.copy_(linear.bias)
        return out

    def dequantized_weight(self, dtype):
        """The float ``(out, in)`` weight the forward multiplies by."""
        return _dequantized(self.quant_weight, self.weight_scale, dtype)

    def forward(self, x):
        return tF.linear(x, self.dequantized_weight(x.dtype), self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class QuantizedColumnParallelLinear(QuantizedLinear):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "tensor-parallel quantized layers come with the multi-device "
            "port (ROADMAP A7)")


class QuantizedRowParallelLinear(QuantizedColumnParallelLinear):
    pass


def quantize_for_serving(model, algo="weight_only_int8"):
    """Replace every ``torch.nn.Linear`` of ``model`` IN PLACE with its
    :class:`QuantizedLinear` (attention and MLP projections, lm-head);
    embeddings and norms stay float. Idempotent. ``"llm.int8"`` maps to
    the same per-output-channel algorithm, as in the reference. Returns
    the model."""
    if algo not in _ALGOS:
        raise ValueError(f"unsupported serving quantize algo: {algo}")

    def walk(module):
        for name, sub in list(module.named_children()):
            if isinstance(sub, nn.Linear):
                setattr(module, name, QuantizedLinear.from_linear(sub))
            elif not isinstance(sub, QuantizedLinear):
                walk(sub)

    walk(model)
    return model
