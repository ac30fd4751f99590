"""``paddle.static.nn`` control flow (counterpart of
``paddle_tpu/static/nn.py``, which lowers to ``lax.cond`` /
``lax.while_loop`` / ``lax.switch`` under a trace).

Eagerly each op runs as Python: only the taken branch runs, on the
autograd graph, and a loop unrolls (its gradients flow through every
iteration). Under ``jit.to_static`` (TorchDynamo) or ``torch.export`` a
tensor predicate becomes torch's higher-order ``torch.cond`` (both
branches traced, differentiable) and a loop ``while_loop`` over tensor
carries (forward only, as the reference's); a Python predicate stays a
Python branch.
"""
from __future__ import annotations

import torch

from ..tensor._helpers import ensure_tensor

__all__ = ["cond", "while_loop", "case", "switch_case"]


def _tracing():
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def _pred(p):
    return ensure_tensor(p).reshape(()).to(torch.bool)


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """``paddle.static.nn.cond``: run one branch. The branches take no
    arguments (they capture by closure) and return matching structures;
    a missing branch returns None."""
    if true_fn is None:
        true_fn = lambda: None  # noqa: E731  (the reference allows it)
    if false_fn is None:
        false_fn = lambda: None  # noqa: E731
    if not isinstance(pred, torch.Tensor) or not _tracing():
        return true_fn() if bool(pred) else false_fn()
    return torch.cond(_pred(pred), lambda: _own(true_fn()),
                      lambda: _own(false_fn()), ())


def _own(out):
    """A traced branch's outputs as new tensors: ``torch.cond`` takes no
    branch that returns a tensor it closes over (``lambda: x``)."""
    return torch.utils._pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)


def _stable(out, carry):
    out = list(out) if isinstance(out, (list, tuple)) else [out]
    vals = []
    for i, (o, c) in enumerate(zip(out, carry)):
        o = ensure_tensor(o, like=c)
        if o.dtype != c.dtype or o.shape != c.shape:
            raise TypeError(
                f"while_loop: body output {i} has {o.dtype}{list(o.shape)} "
                f"but the loop var is {c.dtype}{list(c.shape)}; carries "
                "must be shape/dtype-stable")
        vals.append(o)
    return vals


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """``paddle.static.nn.while_loop``: ``loop_vars`` is a list; cond and
    body take the vars unpacked and body returns the same structure, of
    the same shapes and dtypes."""
    loop_vars = [ensure_tensor(v) for v in loop_vars]
    if not _tracing():
        vars_ = list(loop_vars)
        while bool(cond_fn(*vars_)):
            vars_ = _stable(body_fn(*vars_), vars_)
        return vars_
    from torch._higher_order_ops.while_loop import while_loop as _while

    # check the carries before the loop op, whose trace would bury the
    # error under its own
    _stable(body_fn(*loop_vars), loop_vars)

    def body(*carry):
        return tuple(_stable(body_fn(*carry), carry))

    out = _while(lambda *carry: _pred(cond_fn(*carry)), body,
                 tuple(loop_vars))
    return list(out)


def case(pred_fn_pairs, default=None, name=None):
    """The first pair whose predicate holds wins; without ``default`` the
    last pair's function is the default (the reference's rule)."""
    if not pred_fn_pairs:
        raise ValueError("case: pred_fn_pairs must be non-empty")
    if default is None:
        default = pred_fn_pairs[-1][1]
        pred_fn_pairs = pred_fn_pairs[:-1]

    def build(pairs):
        if not pairs:
            return default()
        pred, f = pairs[0]
        return cond(pred, f, lambda: build(pairs[1:]))

    return build(list(pred_fn_pairs))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Integer dispatch: ``branch_fns`` a list (index = position) or a
    dict; an index with no branch takes ``default`` (else the last
    branch)."""
    branch_index = ensure_tensor(branch_index)
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
    else:
        keys, fns = list(range(len(branch_fns))), list(branch_fns)
    if default is None:
        default = fns[-1]
    if not _tracing():
        i = int(branch_index)
        return (fns[keys.index(i)] if i in keys else default)()
    idx = branch_index.reshape(())

    def build(j):
        if j == len(keys):
            return default()
        return cond(idx == keys[j], fns[j], lambda: build(j + 1))

    return build(0)
