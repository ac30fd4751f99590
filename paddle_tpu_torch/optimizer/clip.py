"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``.
Each clips a list of gradients (``clip_values``, what the optimizers
call), or, called, a list of ``(param, grad)`` pairs."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class ClipGradBase:
    def clip_values(self, grads):
        """Clipped copies of ``grads`` (a list of tensors)."""
        raise NotImplementedError

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads]
        return [(p, g) for (p, _), g in zip(params_grads,
                                            self.clip_values(grads))]


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element into ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def clip_values(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient whose own L2 norm (in f32) exceeds
    ``clip_norm`` down to that norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def clip_values(self, grads):
        out = []
        for g in grads:
            norm = g.float().square().sum().sqrt()
            scale = torch.where(norm > self.clip_norm,
                                self.clip_norm / torch.clamp_min(norm, 1e-12),
                                1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over all gradients in f32."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def clip_values(self, grads):
        """Clipped copies of ``grads``, each scaled in f32 and cast back
        to its dtype; the scale stays on the device."""
        sq = sum(g.float().square().sum() for g in grads)
        scale = self.clip_norm / torch.clamp_min(torch.sqrt(sq),
                                                 self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]
