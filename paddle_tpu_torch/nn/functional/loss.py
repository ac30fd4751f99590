"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``;
the slice ports ``cross_entropy`` as the pretraining criterion uses it)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy against hard integer labels over the last
    axis, with the log-softmax in f32. Labels equal to ``ignore_index``
    count neither in the sum nor in the mean's denominator (at least 1);
    ``reduction`` is ``"mean"``, ``"sum"`` or ``"none"`` (per-position
    losses, 0 where ignored). Returns f32."""
    if (weight is not None or soft_label or not use_softmax
            or label_smoothing or axis not in (-1, input.dim() - 1)):
        raise NotImplementedError(
            "cross_entropy is ported for hard labels over the last axis "
            "without class weights or label smoothing (ROADMAP A6)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    logp = torch.log_softmax(input.float(), dim=-1)
    lab = label.squeeze(-1) if label.dim() == logp.dim() else label
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, -picked, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
