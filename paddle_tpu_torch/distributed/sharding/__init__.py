"""``paddle.distributed.sharding`` of the port."""
from ..fleet.meta_parallel.sharding.group_sharded import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model,
)
