"""Neural-network layers and functionals of the port."""
from . import functional
from .layer import RMSNorm

__all__ = ["functional", "RMSNorm"]
