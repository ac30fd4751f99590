"""Paddle's grad modes and ``grad`` / ``backward`` on torch's autograd.

The reference runs its own tape of ``jax.vjp`` closures
(``paddle_tpu/core/autograd.py``). Here torch's autograd is the tape: the
grad modes are torch's, and ``grad`` / ``backward`` keep paddle's
signatures and its default cotangent (ones for an output of any shape).
"""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "backward", "grad"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _cotangents(outputs, grad_outputs):
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    grad_outputs = _as_list(grad_outputs)
    return [torch.ones_like(o) if g is None else g
            for o, g in zip(outputs, grad_outputs)]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate into the leaves' ``.grad``."""
    tensors = _as_list(tensors)
    torch.autograd.backward(tensors, _cotangents(tensors, grad_tensors),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """paddle.grad: the gradients of ``outputs`` with respect to
    ``inputs``, always a list (``None`` for an unused input when
    ``allow_unused``); ``.grad`` is left alone."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    if retain_graph is None:
        retain_graph = create_graph
    return list(torch.autograd.grad(
        outputs, inputs, _cotangents(outputs, grad_outputs),
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=allow_unused))
