"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``).
``silu`` is PyTorch's own; ``linear``, ``matmul``, ``embedding``, the
attention functionals, ``rms_norm``, ``layer_norm``, ``softmax`` and the
losses hold amp's cast seam (``paddle_tpu_torch.amp``)."""
from torch.nn.functional import silu

from .activation import gelu, relu, softmax, tanh
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention,
                        sliding_window_attention)
from .common import dropout, embedding, linear, matmul
from . import loss as _loss
from .loss import *  # noqa: F401,F403  (the 27 loss functionals)
from .norm import layer_norm, rms_norm
from .rope import (apply_rotary_emb, build_rope_cache,
                   fused_rotary_position_embedding)

__all__ = ["rms_norm", "layer_norm", "silu", "gelu", "tanh", "relu",
           "dropout", "build_rope_cache", "apply_rotary_emb",
           "fused_rotary_position_embedding",
           "scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sliding_window_attention",
           "linear", "matmul", "embedding", "softmax"] + _loss.__all__
