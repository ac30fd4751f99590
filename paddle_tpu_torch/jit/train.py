"""The training step (counterpart of ``paddle_tpu/jit/train.py``).

``JittedTrainStep(model, criterion, optimizer)`` runs forward, criterion,
backward and the optimizer's update, with the reference's rules: the
optimizer state is made fresh at construction (the live optimizer's own
state is not consumed), ``lr = optimizer.get_lr()`` is read on every call
and the schedule is stepped by the caller, the step number counts from 1,
and the loss comes back as a 0-d device tensor without a host sync.

Unlike the reference, which compiles the step into one XLA program over
immutable arrays, the step runs eagerly as ordinary PyTorch (compiling it,
and capturing it as a CUDA graph, are ROADMAP A1 and A8; the kernels'
ctypes launches would not survive a graph capture today) and updates the
model's own parameters in place, so ``params`` are the model's parameters
and ``sync_to_model`` only hands the optimizer state back.
"""
from __future__ import annotations

import torch

__all__ = ["JittedTrainStep"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class JittedTrainStep:
    """One training step of ``model`` under ``criterion(output, *labels)``
    and ``optimizer``. ``state_sharding_axis`` and ``input_batch_axes``
    (the reference's ZeRO / mesh placement) are not ported (ROADMAP A7);
    ``donate`` is taken for the reference's signature and has nothing to
    do here (the update is in place)."""

    def __init__(self, model, criterion, optimizer, state_sharding_axis=None,
                 input_batch_axes=None, donate=True):
        if state_sharding_axis is not None or input_batch_axes is not None:
            raise NotImplementedError(
                "state_sharding_axis / input_batch_axes need a device mesh, "
                "which is not ported yet (ROADMAP A7)")
        self._model = model
        self._criterion = criterion
        self._optimizer = optimizer
        named = list(model.named_parameters())
        self._params = [p for _, p in named]
        self._states = [optimizer.new_state(p) for p in self._params]
        self._decay_flags = [optimizer._decay_enabled(n) for n, _ in named]
        self._step_no = 0

    def _one_step(self, inputs, labels, lr, step_no):
        for p in self._params:
            p.grad = None
        loss = self._criterion(self._model(*inputs), *labels)
        loss.backward()
        self._optimizer.apply(self._params, [p.grad for p in self._params],
                              self._states, lr, step_no, self._decay_flags)
        for p in self._params:
            p.grad = None
        return loss.detach()

    def __call__(self, inputs, labels):
        """``inputs`` / ``labels``: a tensor or a list of tensors. Returns
        the loss (0-d, on the device)."""
        loss = self._one_step(_as_list(inputs), _as_list(labels),
                              self._optimizer.get_lr(), self._step_no + 1)
        self._step_no += 1
        return loss

    def run_steps(self, inputs_stacked, labels_stacked):
        """K steps over inputs / labels with a leading step dim (K, ...),
        one learning rate read for all of them (the reference's one
        dispatch); returns the (K,) losses."""
        ins, lbs = _as_list(inputs_stacked), _as_list(labels_stacked)
        lr = self._optimizer.get_lr()
        losses = []
        for i in range(ins[0].shape[0]):
            losses.append(self._one_step([t[i] for t in ins],
                                         [t[i] for t in lbs], lr,
                                         self._step_no + 1))
            self._step_no += 1
        return torch.stack(losses)

    def sync_to_model(self):
        """Hand the step's optimizer state and step count to the live
        optimizer (the parameters are the model's own already)."""
        for p, st in zip(self._params, self._states):
            self._optimizer._states[id(p)] = st
        self._optimizer._step_count = self._step_no

    @property
    def params(self):
        return self._params
