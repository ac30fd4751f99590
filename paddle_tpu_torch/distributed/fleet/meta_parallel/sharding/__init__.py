from .group_sharded import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
    ShardedOptimizer, group_sharded_parallel, save_group_sharded_model,
)
