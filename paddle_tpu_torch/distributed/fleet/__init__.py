"""``paddle.distributed.fleet`` of the port: its ``utils`` (recompute)."""
from . import utils

__all__ = ["utils"]
