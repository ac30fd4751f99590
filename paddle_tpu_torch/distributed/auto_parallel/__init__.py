"""``paddle.distributed.auto_parallel`` of the port: ``ProcessMesh``, the
placements and ``shard_tensor`` family on a mesh of one process, and the
one-device ``Engine`` (larger meshes: ROADMAP A7)."""
from .api import (Partial, Replicate, Shard, dtensor_from_fn, reshard,
                  shard_layer, shard_tensor)
from .engine import Engine
from .process_mesh import ProcessMesh

__all__ = ["ProcessMesh", "shard_tensor", "dtensor_from_fn", "reshard",
           "shard_layer", "Shard", "Replicate", "Partial", "Engine"]
