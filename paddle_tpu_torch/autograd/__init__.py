"""paddle.autograd (the reference's ``paddle_tpu/autograd``) on torch's
autograd: ``PyLayer`` / ``PyLayerContext`` on ``torch.autograd.Function``,
and ``jacobian``, ``hessian``, ``vjp`` and ``jvp`` on
``torch.autograd.functional``."""
from __future__ import annotations

import torch

from ..core.autograd import (backward, enable_grad, grad, is_grad_enabled,
                             no_grad, set_grad_enabled)

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext", "jacobian",
           "hessian", "vjp", "jvp"]


class PyLayerContext:
    """What ``forward`` saves for ``backward``: ``save_for_backward`` and
    ``saved_tensor()`` (a method, as paddle's), plus any attribute."""

    def __init__(self, ctx=None):
        self._ctx = ctx
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved


class _Function(torch.autograd.Function):
    """One torch Function carries every PyLayer: ``forward`` runs the
    user's static forward with a ``PyLayerContext`` (grad off), and
    ``backward`` the user's backward, whose grads line up with the
    forward's tensor inputs, in order."""

    @staticmethod
    def forward(ctx, cls, kwargs, *args):
        pctx = PyLayerContext(ctx)
        ctx.pyctx, ctx.cls = pctx, cls
        ctx.tensor_pos = [i for i, a in enumerate(args)
                          if isinstance(a, torch.Tensor)]
        out = cls.forward(pctx, *args, **kwargs)
        ctx.single = isinstance(out, torch.Tensor)
        return out

    @staticmethod
    def backward(ctx, *grads):
        gin = ctx.cls.backward(ctx.pyctx, *grads)
        gin = (gin,) if isinstance(gin, torch.Tensor) or gin is None \
            else tuple(gin)
        out = [None] * (len(ctx.needs_input_grad) - 2)
        for pos, g in zip(ctx.tensor_pos, gin):
            out[pos] = g
        return (None, None, *out)


class PyLayer:
    """paddle.autograd.PyLayer: subclass with static ``forward(ctx,
    *args)`` and ``backward(ctx, *grads)``; ``apply`` stitches them into
    torch's autograd (``backward`` returns one grad per tensor input of
    ``forward``, in order)."""

    @classmethod
    def apply(cls, *args, **kwargs):
        return _Function.apply(cls, kwargs, *args)


def _inputs(xs):
    single = isinstance(xs, torch.Tensor)
    return single, (xs,) if single else tuple(xs)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """The dense Jacobian of ``func`` at ``xs`` (a tensor, or a tuple of
    one block per input)."""
    single, ins = _inputs(xs)
    jac = torch.autograd.functional.jacobian(
        lambda *a: func(*a), ins, create_graph=create_graph)
    return jac[0] if single else jac


def hessian(func, xs, create_graph=False, allow_unused=False):
    """The Hessian of a scalar-valued ``func`` at ``xs``."""
    single, ins = _inputs(xs)
    hes = torch.autograd.functional.hessian(
        lambda *a: func(*a), ins, create_graph=create_graph)
    return hes[0][0] if single else hes


def _ones_like_out(out):
    if isinstance(out, torch.Tensor):
        return torch.ones_like(out)
    return tuple(_ones_like_out(o) for o in out)


def vjp(func, xs, v=None):
    """(outputs, vector-Jacobian product); ``v`` defaults to ones shaped
    like the outputs."""
    single, ins = _inputs(xs)
    ins = tuple(x.detach().requires_grad_(True) for x in ins)
    with torch.enable_grad():
        out = func(*ins)
        cot = _ones_like_out(out) if v is None else v
        outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        cots = (cot,) if isinstance(cot, torch.Tensor) else tuple(cot)
        if len(outs) != len(cots):
            raise ValueError(f"vjp: v has {len(cots)} leaves but func "
                             f"produced {len(outs)} outputs")
        grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    grads = tuple(torch.zeros_like(x) if g is None else g
                  for x, g in zip(ins, grads))
    out = out.detach() if isinstance(out, torch.Tensor) else tuple(
        o.detach() for o in out)
    return out, grads[0] if single else grads


def jvp(func, xs, v=None):
    """(outputs, Jacobian-vector product); ``v`` defaults to ones shaped
    like the inputs."""
    single, ins = _inputs(xs)
    if v is None:
        tang = tuple(torch.ones_like(x) for x in ins)
    else:
        tang = (v,) if isinstance(v, torch.Tensor) else tuple(v)
        if len(tang) != len(ins):
            raise ValueError(f"jvp: v has {len(tang)} entries for "
                             f"{len(ins)} inputs")
    out, t = torch.autograd.functional.jvp(lambda *a: func(*a), ins, tang)
    return out, t
