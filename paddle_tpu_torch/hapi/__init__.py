"""``paddle.hapi`` of the port: ``Model``, the callbacks, ``summary`` and
``flops``."""
from . import callbacks
from .model import Model
from .summary import flops, summary

__all__ = ["Model", "callbacks", "summary", "flops"]
