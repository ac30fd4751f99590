"""Incubating distributed models: ``moe``."""
from . import moe

__all__ = ["moe"]
