"""The port's training step (counterpart of ``paddle_tpu/jit``)."""
from .train import JittedTrainStep

__all__ = ["JittedTrainStep"]
