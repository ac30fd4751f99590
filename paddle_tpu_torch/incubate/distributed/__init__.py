"""Incubating distributed features of the port (counterpart of
``paddle_tpu/incubate/distributed``): the serial MoE layer in
``models.moe``."""
from . import models

__all__ = ["models"]
