"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``): the
protobuf tree of upstream Paddle as a plain attribute tree with the same
field names (``hybrid_configs``, ``pipeline_configs``, ``sharding``,
``sharding_configs``, ...).
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class _Config(dict):
    """Dict with attribute access (mirrors proto message fields)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        # hybrid parallel degrees — the reference's topology order is
        # ["dp", "pp", "sharding", "sep", "mp"]
        self.hybrid_configs = _Config(
            dp_degree=1, mp_degree=1, pp_degree=1, sharding_degree=1,
            sep_degree=1,
            pp_configs=_Config(delay_scale_loss=False,
                               enable_timer=False,
                               sharding_comm_overlap=False),
            mp_configs=_Config(sync_param=False, sync_grad=False,
                               sync_moment=False),
        )
        self.amp = False
        self.amp_configs = _Config(
            init_loss_scaling=32768.0, use_dynamic_loss_scaling=True,
            custom_white_list=[], custom_black_list=[], use_pure_fp16=False,
            use_bf16=False,
        )
        self.recompute = False
        self.recompute_configs = _Config(checkpoints=[])
        self.sharding = False
        self.sharding_configs = _Config(
            stage=1, degree=1, offload=False, accumulate_steps=1,
        )
        self.pipeline = False
        self.pipeline_configs = _Config(
            accumulate_steps=1, micro_batch_size=1, schedule_mode="1F1B",
        )
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Config(tensor_parallel_degree=1)
        self.gradient_merge = False
        self.gradient_merge_configs = _Config(k_steps=1, avg=True)
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.gradient_scale_configs = _Config(scale_strategy="avg")
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1

    def __setattr__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, _Config):
            current = self.__dict__.get(key)
            if isinstance(current, _Config):
                merged = _Config(current)
                merged.update(value)
                value = merged
            else:
                value = _Config(value)
        object.__setattr__(self, key, value)

    def __repr__(self):
        hc = self.hybrid_configs
        return (
            "DistributedStrategy(hybrid: dp={dp} mp={mp} pp={pp} "
            "sharding={sh} sep={sep})".format(
                dp=hc.dp_degree, mp=hc.mp_degree, pp=hc.pp_degree,
                sh=hc.sharding_degree, sep=hc.sep_degree,
            )
        )
