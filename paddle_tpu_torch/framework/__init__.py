"""``paddle.framework`` of the port: ``save`` / ``load``."""
from .io import load, save

__all__ = ["save", "load"]
