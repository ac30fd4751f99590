"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``).
``linear``, ``matmul``, ``embedding``, the attention functionals,
``rms_norm``, ``layer_norm``, ``softmax`` and the losses hold amp's cast
seam (``paddle_tpu_torch.amp``)."""
import importlib as _importlib

from . import activation as _activation
from . import attention as _attention
from . import conv as _conv
from . import loss as _loss
from . import pooling as _pooling
from .activation import *  # noqa: F401,F403  (the reference's activations)
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention,
                        sliding_window_attention)
from . import common as _common
from .common import *  # noqa: F401,F403  (linear ... gather_tree)
from .conv import *  # noqa: F401,F403  (conv1d ... conv3d_transpose)
from .loss import *  # noqa: F401,F403  (the 27 loss functionals)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize, rms_norm)
from .pooling import *  # noqa: F401,F403  (max / avg / adaptive / unpool)
from .rope import (apply_rotary_emb, build_rope_cache,
                   fused_rotary_position_embedding)

# the submodule, loaded here (its loading binds the package's name
# ``flash_attention`` to it) and the name bound back to the function, so
# that ``F.flash_attention`` stays the function, as in the reference
_importlib.import_module(__name__ + ".flash_attention")
flash_attention = _attention.flash_attention  # noqa: F811

__all__ = (["rms_norm", "layer_norm", "batch_norm", "instance_norm",
            "group_norm", "local_response_norm", "normalize", "dropout",
            "build_rope_cache", "apply_rotary_emb",
            "fused_rotary_position_embedding",
            "scaled_dot_product_attention", "flash_attention",
            "flash_attn_unpadded", "sliding_window_attention"]
           + _common.__all__ + _activation.__all__ + _conv.__all__
           + _pooling.__all__ + _loss.__all__)
