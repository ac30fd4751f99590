"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``).
``silu`` is PyTorch's own; ``linear``, ``matmul``, ``embedding``, the
attention functionals, ``rms_norm``, ``softmax`` and the losses hold amp's
cast seam (``paddle_tpu_torch.amp``)."""
from torch.nn.functional import silu

from .activation import softmax
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention,
                        sliding_window_attention)
from .common import embedding, linear, matmul
from . import loss as _loss
from .loss import *  # noqa: F401,F403  (the 27 loss functionals)
from .norm import rms_norm
from .rope import apply_rotary_emb, build_rope_cache

__all__ = ["rms_norm", "silu", "build_rope_cache", "apply_rotary_emb",
           "scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sliding_window_attention",
           "linear", "matmul", "embedding", "softmax"] + _loss.__all__
