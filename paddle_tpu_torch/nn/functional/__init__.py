"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``).
``silu`` and the linear/embedding ops are PyTorch's own."""
from torch.nn.functional import silu

from .norm import rms_norm
from .rope import apply_rotary_emb, build_rope_cache

__all__ = ["rms_norm", "silu", "build_rope_cache", "apply_rotary_emb"]
