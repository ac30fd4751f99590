"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``; the slice ports ``rms_norm``)."""
from __future__ import annotations

from ...ops.rms_norm import RMSNormFunction

__all__ = ["rms_norm"]


def rms_norm(x, weight, bias=None, epsilon=1e-6, begin_norm_axis=-1):
    """RMSNorm over dims ``[begin_norm_axis:]``, the hot norm of
    Llama-family models. The normalized dims are flattened into one
    feature axis and go through :class:`RMSNormFunction`: K1 forward and
    K6 backward on CUDA tensors, their plain versions on CPU tensors. A
    kernel failure raises: there is no second path to fall back to."""
    if weight is None or bias is not None:
        raise NotImplementedError(
            "rms_norm without a weight or with a bias is not ported yet "
            "(ROADMAP A6)")
    axis0 = begin_norm_axis % x.dim()
    lead = x.shape[:axis0]
    out = RMSNormFunction.apply(x.reshape(*lead, -1), weight.reshape(-1),
                                epsilon)
    return out.reshape(x.shape)
