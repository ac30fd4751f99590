"""``paddle.distributed.fleet.utils``: recompute."""
from .recompute import recompute, recompute_sequential, should_remat_layer

__all__ = ["recompute", "recompute_sequential", "should_remat_layer"]
