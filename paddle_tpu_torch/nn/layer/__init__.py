"""Layers of the port. ``Linear`` and ``Embedding`` are ``torch.nn``'s
with amp's cast seam in their forward (the weight-layout difference is
handled by ``nlp.convert``); the containers are ``torch.nn``'s under
paddle's names; the conv, norm, pooling, resampling and activation layers
are paddle's over the port's functionals; the loss layers call the loss
functionals; the transformer layers attend through the port's SDPA."""
from . import common as _common
from . import conv as _conv
from . import loss as _loss
from . import norm as _norm
from . import transformer as _transformer
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403  (the 21 loss layers)
from .norm import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = (_common.__all__ + _conv.__all__ + _norm.__all__ + _loss.__all__
           + _transformer.__all__)
