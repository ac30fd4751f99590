"""The training step (counterpart of ``paddle_tpu/jit/train.py``).

``JittedTrainStep(model, criterion, optimizer)`` runs forward, criterion,
backward and the optimizer's update, with the reference's rules: the
optimizer state is made fresh at construction (the live optimizer's own
state is not consumed), ``lr = optimizer.get_lr()`` is read on every call
and the schedule is stepped by the caller, the step number counts from 1,
and the loss comes back as a 0-d device tensor without a host sync.

Frozen parameters: the step differentiates, keeps optimizer state for and
updates only the parameters with ``requires_grad`` (the reference's
``not stop_gradient``); a frozen parameter gets no state and no update
and stays bit-equal. This is the reference's eager loop's rule
(``Optimizer.step`` updates ``trainable`` parameters with a gradient).
The reference's jitted step instead differentiates and updates every
named parameter, frozen ones included (``paddle_tpu/jit/train.py:50``,
``:113-122``); the port does not copy that (ROADMAP queue C): with LoRA
at 7B it would need optimizer state for every frozen weight. A model
whose parameters are all trainable steps as before.

Unlike the reference, which compiles the step into one XLA program over
immutable arrays, the step runs eagerly as ordinary PyTorch (compiling it
is ROADMAP A8; capturing it as a CUDA graph is ROADMAP A1, which waits
for B2.2: the kernels' launches themselves are capturable, as the decode
quantum's graph shows) and updates the model's own parameters in place,
so ``params`` are the model's trainable parameters and ``sync_to_model``
only hands the optimizer state back.

Under the hybrid mesh (``fleet.init``) each rank runs this step on its
part of the batch: ``input_batch_axes`` (default ``("dp",)``, the
reference's) splits dim 0 of every input and label over those axes, the
gradients are averaged over them (where the model's wrapper or the
sharding does not already), and the loss returned is the global batch's
(the ranks' losses averaged: equal when every rank's part counts as many
positions, as the Llama criterion's unpacked loss does).
``state_sharding_axis="sharding"`` shards the optimizer state over that
axis (stage 1: ``ShardedOptimizer``); stage-3 shards update in place.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel import mesh as mesh_state

__all__ = ["JittedTrainStep"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class JittedTrainStep:
    """One training step of ``model`` under ``criterion(output, *labels)``
    and ``optimizer``. ``state_sharding_axis`` and ``input_batch_axes``
    place the step on the hybrid mesh (see the module's docstring; both
    are ignored without a mesh, as in the reference); ``donate`` is taken
    for the reference's signature and has nothing to do here (the update
    is in place)."""

    def __init__(self, model, criterion, optimizer, state_sharding_axis=None,
                 input_batch_axes=None, donate=True):
        mesh = mesh_state.get_mesh()
        self._batch_group = None
        self._avg_groups = []
        if mesh is not None:
            if state_sharding_axis is not None:
                from ..distributed.fleet.meta_parallel.sharding import (
                    ShardedOptimizer)

                optimizer = ShardedOptimizer(
                    optimizer, getattr(optimizer, "_stage", 1),
                    axis=state_sharding_axis)
            axes = tuple(input_batch_axes) if input_batch_axes is not None \
                else ("dp",)
            if axes:
                self._batch_group = mesh.fused(axes)
            # the axes whose gradients the model's wrapper, stage 3 or the
            # sharded optimizer already average
            synced = set(getattr(model, "_grad_synced_axes", ())) | set(
                getattr(optimizer, "_grad_synced_axes", ()))
            self._avg_groups = [mesh.groups[a] for a in axes
                                if a not in synced]
        self._model = model
        self._criterion = criterion
        self._optimizer = optimizer
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self._params = [p for _, p in named]
        self._states = [optimizer.new_state(p) for p in self._params]
        self._decay_flags = [optimizer._decay_enabled(n, p) for n, p in named]
        self._step_no = 0

    def _local(self, t, dim=0):
        """This rank's part of a batch along ``dim`` (the whole batch
        without a mesh)."""
        g = self._batch_group
        if g is None or not isinstance(t, torch.Tensor):
            return t
        if t.shape[dim] % g.nranks:
            raise ValueError(
                f"batch {t.shape[dim]} does not split over the "
                f"{g.nranks} ranks of the input batch axes")
        return t.chunk(g.nranks, dim=dim)[g.rank]

    def _one_step(self, inputs, labels, lr, step_no):
        for p in self._params:
            p.grad = None
        loss = self._criterion(self._model(*inputs), *labels)
        loss.backward()
        for g in self._avg_groups:
            for p in self._params:
                if p.grad is not None:
                    dist.all_reduce(p.grad, op=dist.ReduceOp.AVG,
                                    group=g.process_group)
        self._optimizer.apply(self._params, [p.grad for p in self._params],
                              self._states, lr, step_no, self._decay_flags)
        for p in self._params:
            p.grad = None
        loss = loss.detach()
        if self._batch_group is not None:
            # the global batch's loss, in a tensor of its own
            loss = loss.clone()
            dist.all_reduce(loss, op=dist.ReduceOp.AVG,
                            group=self._batch_group.process_group)
        return loss

    def __call__(self, inputs, labels):
        """``inputs`` / ``labels``: a tensor or a list of tensors. Returns
        the loss (0-d, on the device)."""
        loss = self._one_step([self._local(t) for t in _as_list(inputs)],
                              [self._local(t) for t in _as_list(labels)],
                              self._optimizer.get_lr(), self._step_no + 1)
        self._step_no += 1
        return loss

    def run_steps(self, inputs_stacked, labels_stacked):
        """K steps over inputs / labels with a leading step dim (K, ...),
        one learning rate read for all of them (the reference's one
        dispatch); returns the (K,) losses."""
        ins = [self._local(t, 1) for t in _as_list(inputs_stacked)]
        lbs = [self._local(t, 1) for t in _as_list(labels_stacked)]
        lr = self._optimizer.get_lr()
        losses = []
        for i in range(ins[0].shape[0]):
            losses.append(self._one_step([t[i] for t in ins],
                                         [t[i] for t in lbs], lr,
                                         self._step_no + 1))
            self._step_no += 1
        return torch.stack(losses)

    def resume_from_optimizer(self):
        """Start from the live optimizer's state and step count where it
        holds state for a parameter (after its ``set_state_dict``): the
        inverse of :meth:`sync_to_model`."""
        live = self._optimizer._states
        self._states = [live.get(id(p), st)
                        for p, st in zip(self._params, self._states)]
        self._step_no = self._optimizer._step_count

    def sync_to_model(self):
        """Hand the step's optimizer state and step count to the live
        optimizer (the parameters are the model's own already)."""
        for p, st in zip(self._params, self._states):
            self._optimizer._states[id(p)] = st
        self._optimizer._step_count = self._step_no

    @property
    def params(self):
        return self._params
