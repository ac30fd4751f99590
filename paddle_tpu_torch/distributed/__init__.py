"""Distributed utilities of the port (counterpart of
``paddle_tpu/distributed``). Ported so far: recompute (activation
checkpointing) under ``fleet.utils``; the device mesh, tensor and context
parallelism are ROADMAP A7."""
from . import fleet

__all__ = ["fleet"]
