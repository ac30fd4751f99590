"""DataParallel (counterpart of ``paddle_tpu/distributed/parallel.py``).

The reference shards the batch over the ``dp`` mesh axis and lets XLA
reduce the gradients. Here each rank runs its own batch: at wrap the
parameters (and buffers) are broadcast from the group's first rank, and
each parameter's gradient is averaged over the group as soon as backward
has accumulated it (a post-accumulate hook). The wrapper is no module,
so the model's parameter names stay as they are.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..parallel import mesh as mesh_state

__all__ = ["DataParallel", "broadcast_parameters", "average_grads_hook"]


@torch.no_grad()
def broadcast_parameters(tensors, group):
    """Every tensor from the group's first rank (a global rank)."""
    for t in tensors:
        dist.broadcast(t.data, group.ranks[0], group=group.process_group)


def average_grads_hook(params, group, enabled=lambda: True):
    """Average each parameter's gradient over ``group`` once backward has
    accumulated it; returns the hook handles."""
    def hook(p):
        if enabled() and p.grad is not None:
            dist.all_reduce(p.grad, op=dist.ReduceOp.AVG,
                            group=group.process_group)

    return [p.register_post_accumulate_grad_hook(hook) for p in params
            if p.requires_grad]


class DataParallel:
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        self._layers = layers
        self._group = group if group is not None else \
            mesh_state.axis_group("dp")
        self._sync = True
        if self._group is not None:
            broadcast_parameters(
                list(layers.parameters()) + list(layers.buffers()),
                self._group)
            self._handles = average_grads_hook(
                list(layers.parameters()), self._group, lambda: self._sync)
        self._grad_synced_axes = tuple(
            getattr(layers, "_grad_synced_axes", ())) + (
            ("dp",) if self._group is not None else ())

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    forward = __call__

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    @contextlib.contextmanager
    def no_sync(self):
        """Leave the gradients unaveraged inside (accumulate locally)."""
        self._sync = False
        try:
            yield
        finally:
            self._sync = True
