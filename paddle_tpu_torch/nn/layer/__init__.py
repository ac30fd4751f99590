"""Layers of the port; ``Linear`` and ``Embedding`` are ``torch.nn``'s
(the weight-layout difference is handled by ``nlp.convert``)."""
from .norm import RMSNorm

__all__ = ["RMSNorm"]
