"""Distributed utilities of the port (counterpart of
``paddle_tpu/distributed``). Ported so far: recompute (activation
checkpointing) under ``fleet.utils``, and ``auto_parallel`` on one device
(``ProcessMesh``, ``shard_tensor`` on a one-process mesh, ``Engine``).
The multi-rank device mesh, tensor and context parallelism are ROADMAP
A7."""
from . import auto_parallel, fleet
from .auto_parallel import (Engine, Partial, ProcessMesh, Replicate, Shard,
                            dtensor_from_fn, reshard, shard_layer,
                            shard_tensor)

__all__ = ["auto_parallel", "fleet", "Engine", "ProcessMesh",
           "shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
           "Shard", "Replicate", "Partial"]
