"""Neural-network layers, functionals, initializers and quantization of
the port. ``Layer`` and ``ParamAttr`` are paddle's on ``torch.nn.Module``;
the grad-clip classes live under ``nn`` too, as in the reference."""
from . import functional, initializer, layer, quant
from . import functional as F  # noqa: F401
from .layer import *  # noqa: F401,F403
from .layer.layers import Layer, ParamAttr
from ..optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                              ClipGradByValue)

__all__ = (["functional", "initializer", "layer", "quant", "Layer",
            "ParamAttr", "ClipGradByGlobalNorm", "ClipGradByNorm",
            "ClipGradByValue"] + layer.__all__)
