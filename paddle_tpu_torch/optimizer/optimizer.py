"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``; the
slice ports ``Optimizer``, ``Adam`` and ``AdamW``).

Each optimizer keeps, per parameter, a dict of state tensors: Adam's two
moments (f32 or bf16, ``moment_dtype``) and, with ``multi_precision``, an
f32 master copy of a bf16/fp16 parameter. The update math is f32 and the
rule is the reference's ``_apply_one``: the gradient is cast to the
working copy's dtype (the master when there is one), L2 decay is added to
it (Adam), or decoupled decay ``lr * wd * old`` is taken off the updated
working copy (AdamW); the master is then written back into the parameter.
Unlike the reference, whose arrays are immutable, the update writes the
parameter, the master and the moments IN PLACE. It is not
``torch.optim.AdamW``, which keeps neither master weights nor bf16
moments.

``parameters`` takes tensors, or ``(name, tensor)`` pairs such as
``model.named_parameters()``; ``apply_decay_param_fun`` receives that name
(the reference passes ``param.name``), or a tensor's own ``name``
attribute, or ``param_<i>``.
"""
from __future__ import annotations

import numpy as np
import torch

from .clip import ClipGradByGlobalNorm
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "bf16": torch.bfloat16}


def _named(parameters):
    out = []
    for i, item in enumerate(parameters):
        if isinstance(item, tuple):
            name, p = item
        else:
            p = item
            name = getattr(p, "name", None) or f"param_{i}"
        out.append((name, p))
    return out


class Optimizer:
    _decoupled_wd = False  # AdamW-style decay

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, **kwargs):
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "weight_decay is ported as a float coefficient (L2, or "
                "decoupled for AdamW)")
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradByGlobalNorm):
            raise NotImplementedError(
                "grad_clip is ported as ClipGradByGlobalNorm")
        self._lr = learning_rate
        self._named = _named(parameters) if parameters is not None else []
        self._wd = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._states = {}  # id(param) -> state dict
        self._step_count = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    # -- state -------------------------------------------------------------
    def _init_state(self, p):
        return {}

    def new_state(self, p):
        """A fresh state dict for parameter ``p``: the accumulators, plus
        an f32 master copy of a bf16/fp16 ``p`` under multi_precision."""
        st = self._init_state(p)
        if self._multi_precision and p.dtype in _LOW_PRECISION:
            st["master"] = p.detach().float()
        return st

    def _state_for(self, p):
        if id(p) not in self._states:
            self._states[id(p)] = self.new_state(p)
        return self._states[id(p)]

    def _decay_enabled(self, name) -> bool:
        """Per-parameter weight-decay gate (AdamW's
        apply_decay_param_fun)."""
        return True

    # -- update ------------------------------------------------------------
    def _update(self, work, g, state, lr, step):
        """New working value (a new tensor) from ``work`` and gradient
        ``g`` (both in the working dtype); accumulators updated in
        place."""
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, params, grads, states, lr, step, decay_flags):
        """The multi-tensor update of one step, in place: ``params``,
        ``grads`` (None counts as zeros), their ``states`` and per-parameter
        ``decay_flags``; ``lr`` a float, ``step`` counted from 1."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_values(grads)
        for p, g, st, decay in zip(params, grads, states, decay_flags):
            work = st.get("master", p)
            g = g.to(work.dtype)
            if self._wd and not self._decoupled_wd and decay:
                g = g + self._wd * work
            new = self._update(work, g, st, lr, step)
            if self._wd and self._decoupled_wd and decay:
                new = new - float(np.float32(lr) * np.float32(self._wd)) * work
            work.copy_(new)
            if work is not p:
                p.copy_(work)

    def step(self):
        """One eager update of every parameter that has a gradient."""
        live = [(n, p) for n, p in self._named
                if p.requires_grad and p.grad is not None]
        if not live:
            return
        params = [p for _, p in live]
        self.apply(params, [p.grad for p in params],
                   [self._state_for(p) for p in params], self.get_lr(),
                   self._step_count + 1,
                   [self._decay_enabled(n) for n, _ in live])
        self._step_count += 1

    def clear_grad(self, set_to_zero=False):
        for _, p in self._named:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # -- serialization -----------------------------------------------------
    def state_dict(self):
        """``step_count``, the schedule's state, and ``<name>_<key>`` for
        every state tensor (the reference's keys)."""
        out = {"step_count": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for name, p in self._named:
            for k, v in self._states.get(id(p), {}).items():
                out[f"{name}_{k}"] = v
        return out


class Adam(Optimizer):
    """Adam; ``moment_dtype="bfloat16"`` stores both moments in bf16 (the
    update math stays f32)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype="float32", name=None,
                 **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        if moment_dtype not in _MOMENT_DTYPES:
            raise ValueError(
                f"moment_dtype must be float32 or bfloat16, got "
                f"{moment_dtype!r}")
        self._moment_dtype = _MOMENT_DTYPES[moment_dtype]

    def _init_state(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device)}

    def _update(self, work, g, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        g32 = g.float()
        m = b1 * state["moment1"].float() + (1 - b1) * g32
        v = b2 * state["moment2"].float() + (1 - b2) * g32.square()
        # the bias corrections in f32, as the reference forms them
        t = np.float32(step)
        m_hat = m / float(1 - np.float32(b1) ** t)
        v_hat = v / float(1 - np.float32(b2) ** t)
        new = work.float() - lr * m_hat / (v_hat.sqrt() + self._eps)
        state["moment1"].copy_(m)
        state["moment2"].copy_(v)
        return new.to(work.dtype)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01) applied to the old
    working copy; ``apply_decay_param_fun(name)`` picks the parameters it
    applies to."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False,
                 moment_dtype="float32", name=None, **kwargs):
        if lr_ratio is not None:
            raise NotImplementedError("AdamW lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         moment_dtype=moment_dtype)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_enabled(self, name) -> bool:
        if self._apply_decay_param_fun is None:
            return True
        return bool(self._apply_decay_param_fun(name))
