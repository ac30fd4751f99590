"""Incubating nn ops of the port: ``FusedMultiTransformer`` (the whole
decoder stack with KV-cache decode and weight-only int8) and the fused
functionals (``incubate.nn.functional``)."""
from . import functional
from .fused_transformer import FusedMultiTransformer

__all__ = ["FusedMultiTransformer", "functional"]
