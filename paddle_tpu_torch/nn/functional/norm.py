"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``). ``rms_norm`` goes through K1 / K6;
the rest have no Pallas kernel in the reference (XLA runs them) and run
as PyTorch ops here, in the reference's rounding order."""
from __future__ import annotations

import torch

from ... import amp
from ...amp import amp_state
from ...ops.rms_norm import RMSNormFunction

__all__ = ["rms_norm", "layer_norm", "batch_norm", "instance_norm",
           "group_norm", "local_response_norm", "normalize"]


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


def _channel_shape(x, ch_axis):
    shape = [1] * x.dim()
    shape[ch_axis] = -1
    return shape


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """BatchNorm over every axis but the channel's (1 under ``NC*``, else
    the last). Unless ``use_global_stats`` (default: not ``training``),
    it normalises by the batch's f32 mean and biased variance and updates
    ``running_mean`` / ``running_var`` IN PLACE by paddle's rule ``r <-
    momentum * r + (1 - momentum) * batch`` (the variance unbiased, n / (n
    - 1)); torch's ``momentum`` is ``1 - momentum``. The normalised value
    is rounded to x's dtype before the weight multiply, as the reference's
    (``:137``). The reference's formula op for op, in every dtype: torch's
    fused ``batch_norm`` backward on the CPU is ~1e-3 (relative) off an
    f64 gradient through a ResNet-18 step where this formula is ~1e-5
    (and the reference ~1e-5). On the card that is several elementwise
    passes where cuDNN would take one (ROADMAP B)."""
    ch = 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1
    track = use_global_stats if use_global_stats is not None else \
        not training
    shape = _channel_shape(x, ch)
    if track:
        mean, var = running_mean, running_var
    else:
        axes = tuple(i for i in range(x.dim()) if i != ch)
        xf = x.float()
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, unbiased=False)
        n = x.numel() // x.shape[ch]
        with torch.no_grad():
            running_mean.mul_(momentum).add_(
                (1 - momentum) * mean.detach().to(running_mean.dtype))
            running_var.mul_(momentum).add_(
                (1 - momentum) * (var.detach() * (n / max(n - 1, 1)))
                .to(running_var.dtype))
    out = ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                   + epsilon)).to(x.dtype)
    return _affine(out, weight, bias, shape)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per-sample, per-channel normalisation over the spatial axes, in x's
    dtype (the running statistics are accepted and, as in the reference,
    not read)."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = (tuple(range(2, x.dim())) if ch == 1
            else tuple(range(1, x.dim() - 1)))
    mean, var = _moments(x, axes)
    out = (x - mean) * torch.rsqrt(var + eps)
    return _affine(out, weight, bias, _channel_shape(x, ch))


def _moments(x, axes):
    """Mean and biased variance over ``axes`` (kept), as ``jnp.mean`` /
    ``jnp.var`` give them: accumulated in f32 for bf16 and fp16 inputs,
    each rounded once to x's dtype."""
    xf = x.float()
    return (xf.mean(dim=axes, keepdim=True).to(x.dtype),
            xf.var(dim=axes, unbiased=False, keepdim=True).to(x.dtype))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """GroupNorm in x's dtype, the reference's order: the groups' mean
    and variance (each rounded to x's dtype), then ``(x - mean) *
    rsqrt(var + eps)`` op by op in x's dtype, then the weight multiply and
    the bias add (promoting). No f32 normalisation as ``layer_norm``'s:
    the reference's ``group_norm`` has none."""
    moved = not data_format.startswith("NC")
    v = x.movedim(-1, 1) if moved else x
    n, c = v.shape[:2]
    spatial = v.shape[2:]
    g = v.reshape((n, num_groups, c // num_groups) + tuple(spatial))
    mean, var = _moments(g, tuple(range(2, g.dim())))
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(v.shape)
    out = _affine(out, weight, bias, [1, c] + [1] * len(spatial))
    return out.movedim(1, -1) if moved else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum of squares over `size` channels) ** beta``,
    the window centred as the reference's (``(size - 1) // 2`` before)."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = x.square().movedim(ch, -1)
    pad_l = (size - 1) // 2
    padded = torch.nn.functional.pad(sq, (pad_l, size - 1 - pad_l))
    c = sq.shape[-1]
    win = torch.stack([padded[..., i:i + c] for i in range(size)]).sum(0)
    div = torch.pow(k + alpha * win, beta)
    return x / div.movedim(-1, ch)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=epsilon)
