"""Incubating ops of the port: the fused layers and functionals
(``incubate.nn``), the serial MoE layer (``incubate.distributed``) and the
optimizer wrappers (``incubate.optimizer``)."""
from . import distributed, nn, optimizer

__all__ = ["nn", "distributed", "optimizer"]
