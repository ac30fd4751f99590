"""Optimizers, schedules and clipping of the port (counterpart of
``paddle_tpu/optimizer``)."""
from . import lr
from .clip import ClipGradByGlobalNorm
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["lr", "Optimizer", "Adam", "AdamW", "ClipGradByGlobalNorm"]
