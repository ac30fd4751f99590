"""``paddle.regularizer`` (counterpart of ``paddle_tpu/regularizer``)."""
from ..optimizer.optimizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
