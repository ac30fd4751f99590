"""Neural-network layers, functionals and quantization of the port."""
from . import functional, quant
from .layer import RMSNorm

__all__ = ["functional", "quant", "RMSNorm"]
