"""Neural-network layers, functionals and quantization of the port."""
from . import functional, layer, quant
from .layer import *  # noqa: F401,F403

__all__ = ["functional", "layer", "quant"] + layer.__all__
