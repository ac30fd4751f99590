"""Mixture of experts (counterpart of
``paddle_tpu/incubate/distributed/models/moe``): the capacity gates and
the serial ``MoELayer``, in its einsum and grouped dispatch modes. Expert
parallelism needs a device mesh (ROADMAP A7)."""
from .gate import GShardGate, SwitchGate, TopKGate
from .moe_layer import MoELayer

__all__ = ["MoELayer", "TopKGate", "GShardGate", "SwitchGate"]
