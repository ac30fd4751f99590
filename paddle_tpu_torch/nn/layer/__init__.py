"""Layers of the port. ``Linear`` and ``Embedding`` are ``torch.nn``'s
with amp's cast seam in their forward (the weight-layout difference is
handled by ``nlp.convert``); ``LayerNorm`` and ``Dropout`` are paddle's
over the port's functionals; the loss layers call the loss functionals."""
from . import loss as _loss
from .common import Dropout, Embedding, Linear
from .loss import *  # noqa: F401,F403  (the 21 loss layers)
from .norm import LayerNorm, RMSNorm

__all__ = ["RMSNorm", "LayerNorm", "Linear", "Embedding",
           "Dropout"] + _loss.__all__
