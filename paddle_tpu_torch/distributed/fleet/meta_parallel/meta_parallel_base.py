"""The meta-parallel base and ``TensorParallel`` (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/meta_parallel_base.py``).

``TensorParallel`` makes the parameters that are not split (norms,
biases of row-parallel layers, plain layers) equal across ``mp`` and
``dp`` at wrap (broadcast from each group's first rank) and averages the
gradients over ``dp`` after backward; the split ones (``is_distributed``)
are broadcast over ``dp`` only."""
from __future__ import annotations

from ....parallel import mesh as mesh_state
from ...parallel import average_grads_hook, broadcast_parameters

__all__ = ["MetaParallelBase", "TensorParallel", "_get_hcg"]


def _get_hcg():
    from ..base.topology import get_hybrid_communicate_group

    return get_hybrid_communicate_group()


class MetaParallelBase:
    def __init__(self, layers, hcg, strategy):
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


class TensorParallel(MetaParallelBase):
    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        params = list(layers.parameters())
        dp, mp = mesh_state.axis_group("dp"), mesh_state.axis_group("mp")
        broadcast_parameters(
            [p for p in params if getattr(p, "_mp_split", None) is None]
            + list(layers.buffers()), mp)
        broadcast_parameters(params + list(layers.buffers()), dp)
        self._handles = average_grads_hook(params, dp)
        self._grad_synced_axes = tuple(
            getattr(layers, "_grad_synced_axes", ())) + ("dp",)
