"""``paddle.distributed.fleet`` of the port (counterpart of
``paddle_tpu/distributed/fleet/__init__.py``).

``fleet.init(is_collective=True, strategy=...)`` starts the process
group (``init_parallel_env``) and builds the hybrid topology and its
groups; ``distributed_model`` wraps the model as the reference does
(stage-3 sharding first, then ``PipelineParallel`` (or the interleave)
for ``pp_degree > 1``, ``TensorParallel`` for ``mp_degree > 1``,
``DataParallel`` otherwise); ``distributed_optimizer`` shards the
optimizer's state when ``strategy.sharding`` is on.
"""
from __future__ import annotations

from ..communication.group import new_group  # noqa: F401
from . import utils  # noqa: F401
from .base.distributed_strategy import DistributedStrategy
from .base.topology import (CommunicateTopology, HybridCommunicateGroup,
                            get_hybrid_communicate_group)
from .meta_parallel.meta_parallel_base import TensorParallel
from .meta_parallel.parallel_layers.pp_layers import (LayerDesc,
                                                      PipelineLayer,
                                                      SharedLayerDesc)
from .meta_parallel.pipeline_parallel import (PipelineParallel,
                                              PipelineParallelWithInterleave)
from .utils.recompute import recompute  # noqa: F401

__all__ = [
    "init", "fleet", "DistributedStrategy", "HybridCommunicateGroup",
    "CommunicateTopology", "get_hybrid_communicate_group",
    "distributed_model", "distributed_optimizer", "PipelineLayer",
    "LayerDesc", "SharedLayerDesc", "PipelineParallel",
    "PipelineParallelWithInterleave", "TensorParallel", "worker_num",
    "worker_index", "barrier_worker", "recompute", "utils",
]

_fleet_state = {"initialized": False, "strategy": None, "hcg": None}


def init(role_maker=None, is_collective=False, strategy=None,
         log_level="INFO", device=None, backend=None):
    """Start the process group (``device`` / ``backend`` as
    ``init_parallel_env``) and install the strategy's topology."""
    from .. import init_parallel_env

    strategy = strategy or DistributedStrategy()
    init_parallel_env(backend=backend, device=device)
    hcg = HybridCommunicateGroup(strategy)
    _fleet_state.update(initialized=True, strategy=strategy, hcg=hcg)
    return None


def is_initialized():
    return _fleet_state["initialized"]


def get_hybrid_parallel_strategy():
    return _fleet_state["strategy"]


def _stage(strategy):
    return int(strategy.sharding_configs.get("stage", 1)) \
        if strategy.sharding else 0


def distributed_model(model):
    strategy = _fleet_state["strategy"] or DistributedStrategy()
    hcg = _fleet_state["hcg"]
    if hcg is None:
        raise RuntimeError("fleet.distributed_model needs fleet.init first")
    hc = strategy.hybrid_configs
    if _stage(strategy) == 3:
        from .meta_parallel.sharding.group_sharded import (
            shard_model_params_stage3)

        shard_model_params_stage3(model)
    if int(hc["pp_degree"]) > 1:
        if getattr(model, "_num_virtual", 1) > 1:
            return PipelineParallelWithInterleave(model, hcg, strategy)
        return PipelineParallel(model, hcg, strategy)
    if int(hc["mp_degree"]) > 1:
        return TensorParallel(model, hcg, strategy)
    from ..parallel import DataParallel

    return DataParallel(model)


def distributed_optimizer(optimizer, strategy=None):
    """With ``strategy.sharding``: the optimizer's state sharded at the
    strategy's stage (1: ``os``, 2: ``os_g``; 3: the stage-3 shards are
    the parameters and the update runs on them)."""
    strategy = strategy or _fleet_state["strategy"] or DistributedStrategy()
    stage = _stage(strategy)
    if stage:
        from .meta_parallel.sharding.group_sharded import ShardedOptimizer

        if stage == 3:
            unsharded = [n for n, p in optimizer._named
                         if getattr(p, "_stage3", None) is None]
            if unsharded:
                raise ValueError(
                    f"stage 3: the optimizer holds parameters that are not "
                    f"stage-3 shards (e.g. {unsharded[0]}); build it from "
                    f"the model after fleet.distributed_model")
        return ShardedOptimizer(optimizer, min(stage, 2))
    return optimizer


def worker_num():
    from .. import get_world_size

    return get_world_size()


def worker_index():
    from .. import get_rank

    return get_rank()


def barrier_worker():
    from .. import barrier

    barrier()


class _FleetFacade:
    """``from paddle.distributed import fleet; fleet.init(...)``."""

    init = staticmethod(init)
    distributed_model = staticmethod(distributed_model)
    distributed_optimizer = staticmethod(distributed_optimizer)
    DistributedStrategy = DistributedStrategy
    worker_num = staticmethod(worker_num)
    worker_index = staticmethod(worker_index)


fleet = _FleetFacade()
