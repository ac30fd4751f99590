"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``; the
slice ports ``ClipGradByGlobalNorm``)."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over all gradients in f32."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def clip_values(self, grads):
        """Clipped copies of ``grads`` (a list of tensors), each scaled in
        f32 and cast back to its dtype; the scale stays on the device."""
        sq = sum(g.float().square().sum() for g in grads)
        scale = self.clip_norm / torch.clamp_min(torch.sqrt(sq),
                                                 self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]
