"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adamax``, ``Adagrad``,
``Adadelta``, ``RMSProp``, ``Lamb``, ``LarsMomentum``, ``Rprop``,
``NAdam``, ``RAdam``, ``ASGD`` and ``LBFGS``, with ``L1Decay`` /
``L2Decay`` weight decay.

Each optimizer keeps, per parameter, a dict of state tensors (Adam's two
moments, f32 or bf16 by ``moment_dtype``; the others' f32 accumulators)
and, with ``multi_precision``, an f32 master copy of a bf16/fp16
parameter. The rule is the reference's ``_apply_one``: the gradient is
cast to the working copy's dtype (the master when there is one), L2 decay
(``coeff * work``) or L1 decay (``coeff * sign(work)``) is added to it, or
AdamW's decoupled decay ``lr * wd * old`` is taken off the updated working
copy; the master is then written back into the parameter. The learning
rate and the step count enter as f32 scalars, as the reference feeds them
(``np.float32`` here), so the f32 rounding order is the reference's.
Unlike the reference, whose arrays are immutable, the update writes the
parameter, the master and the accumulators IN PLACE. It is not
``torch.optim``, which keeps neither master weights nor bf16 moments.

``parameters`` takes tensors, or ``(name, tensor)`` pairs such as
``model.named_parameters()``; ``apply_decay_param_fun`` receives that name
(the reference passes ``param.name``), or a tensor's own ``name``
attribute, or ``param_<i>``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.dtype import one_of
from .clip import ClipGradBase
from .lr import LRScheduler

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
    "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "Rprop", "NAdam",
    "RAdam", "ASGD", "LBFGS", "L1Decay", "L2Decay",
]

_LOW_PRECISION = (torch.float16, torch.bfloat16)
_MOMENT_DTYPES = (torch.float32, torch.bfloat16)
_f32 = np.float32


class L2Decay:
    """L2 weight decay: ``coeff * param`` added to the gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    """L1 weight decay: ``coeff * sign(param)`` added to the gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _wd_coeff(weight_decay):
    if weight_decay is None:
        return 0.0, "l2"
    if isinstance(weight_decay, L2Decay):
        return weight_decay.coeff, "l2"
    if isinstance(weight_decay, L1Decay):
        return weight_decay.coeff, "l1"
    return float(weight_decay), "l2"


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


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class Optimizer:
    _decoupled_wd = False  # AdamW-style decay

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, **kwargs):
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradBase):
            raise TypeError(
                f"grad_clip must be a ClipGradBy* instance, got "
                f"{type(grad_clip).__name__}")
        self._lr = learning_rate
        self._named = _named(parameters) if parameters is not None else []
        self._wd, self._wd_kind = _wd_coeff(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._states = {}  # id(param) -> state dict
        self._step_count = 0

    @property
    def _parameter_list(self):
        return [p for _, p in self._named]

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

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

    def _decay_enabled(self, name, param=None) -> bool:
        """Per-parameter weight-decay gate (AdamW's
        apply_decay_param_fun, Lamb's exclude_from_weight_decay_fn)."""
        return True

    # -- update ------------------------------------------------------------
    def _update(self, work, g, state, lr, step, decay=True):
        """New working value (a new tensor) from ``work`` and gradient
        ``g`` (both in the working dtype); ``lr`` and ``step`` are
        ``np.float32``; accumulators updated in place."""
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
        lr32, t = _f32(lr), _f32(step)
        for p, g, st, decay in zip(params, grads, states, decay_flags):
            work = st.get("master", p)
            g = g.to(work.dtype)
            if self._wd and not self._decoupled_wd and decay:
                g = g + self._wd * (work if self._wd_kind == "l2"
                                    else torch.sign(work))
            new = self._update(work, g, st, lr32, t, decay)
            if self._wd and self._decoupled_wd and decay:
                new = new - float(lr32 * _f32(self._wd)) * work
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
                   [self._decay_enabled(n, p) for n, p in live])
        self._step_count += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=False):
        for _, p in self._named:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

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

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load :meth:`state_dict`'s keys into this optimizer's state
        (tensors or arrays, copied); warns about every missing key."""
        self._step_count = state_dict.get("step_count", 0)
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state_dict:
            self._lr.set_state_dict(dict(state_dict["LR_Scheduler"]))
        missing = []
        for name, p in self._named:
            st = self._state_for(p)
            for k in list(st):
                key = f"{name}_{k}"
                if key in state_dict:
                    v = torch.as_tensor(np.asarray(state_dict[key])
                                        if not isinstance(state_dict[key],
                                                          torch.Tensor)
                                        else state_dict[key])
                    st[k] = v.to(device=st[k].device,
                                 dtype=st[k].dtype).clone()
                else:
                    missing.append(key)
        if missing:
            warnings.warn(
                f"optimizer.set_state_dict: {len(missing)} accumulator keys "
                f"not found in the checkpoint (e.g. {missing[0]!r}); those "
                "accumulators keep their current values. Name parameters "
                "(pass named_parameters()) for stable keys.",
                RuntimeWarning)


class SGD(Optimizer):
    """``p - lr * g``, the learning rate rounded to the parameter's
    dtype first."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update(self, work, g, state, lr, step, decay=True):
        lr_p = torch.tensor(float(lr), dtype=work.dtype, device=work.device)
        return work - lr_p * g


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": _zeros(p)}

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        v = self._momentum * state["velocity"] + g32
        upd = g32 + self._momentum * v if self._nesterov else v
        state["velocity"].copy_(v)
        return (work.float() - float(lr) * upd).to(work.dtype)


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
        dt = one_of(moment_dtype, _MOMENT_DTYPES)
        if dt is None:
            raise ValueError(
                f"moment_dtype must be float32 or bfloat16, got "
                f"{moment_dtype!r}")
        self._moment_dtype = dt

    def _init_state(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device)}

    def _moments(self, g32, state):
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"].float() + (1 - b1) * g32
        v = b2 * state["moment2"].float() + (1 - b2) * g32.square()
        return m, v

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        m, v = self._moments(g32, state)
        # the bias corrections in f32, as the reference forms them
        m_hat = m / float(1 - _f32(self._beta1) ** step)
        v_hat = v / float(1 - _f32(self._beta2) ** step)
        new = work.float() - float(lr) * m_hat / (v_hat.sqrt() + self._eps)
        state["moment1"].copy_(m)
        state["moment2"].copy_(v)
        return new.to(work.dtype)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01) applied to the old
    working copy; ``apply_decay_param_fun(name)`` picks the parameters it
    applies to. ``lr_ratio`` is accepted and not used, as in the
    reference (``paddle_tpu/optimizer/optimizer.py:385-402``)."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False,
                 moment_dtype="float32", name=None, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         moment_dtype=moment_dtype)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_enabled(self, name, param=None) -> bool:
        if self._apply_decay_param_fun is None:
            return True
        return bool(self._apply_decay_param_fun(name))


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * state["inf_norm"], g32.abs())
        rate = float(lr / (1 - _f32(self._beta1) ** step))
        state["moment"].copy_(m)
        state["inf_norm"].copy_(u)
        return (work.float() - rate * m / (u + self._eps)).to(work.dtype)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full(p.shape, self._init_acc,
                                     dtype=torch.float32, device=p.device)}

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        acc = state["moment"] + g32.square()
        state["moment"].copy_(acc)
        return (work.float() - float(lr) * g32
                / (acc.sqrt() + self._eps)).to(work.dtype)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._eps, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        rho = self._rho
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g32.square()
        upd = ((state["avg_squared_update"] + self._eps).sqrt()
               / (asg + self._eps).sqrt()) * g32
        asu = rho * state["avg_squared_update"] + (1 - rho) * upd.square()
        state["avg_squared_grad"].copy_(asg)
        state["avg_squared_update"].copy_(asu)
        return (work.float() - float(lr) * upd).to(work.dtype)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        st = {"mean_square": _zeros(p), "momentum_acc": _zeros(p)}
        if self._centered:
            st["mean_grad"] = _zeros(p)
        return st

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * g32.square()
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g32
            denom = (ms - mg.square() + self._eps).sqrt()
            state["mean_grad"].copy_(mg)
        else:
            denom = (ms + self._eps).sqrt()
        mom = self._momentum * state["momentum_acc"] \
            + float(lr) * g32 / denom
        state["mean_square"].copy_(ms)
        state["momentum_acc"].copy_(mom)
        return (work.float() - mom).to(work.dtype)


class Lamb(Optimizer):
    """LAMB: Adam's direction plus ``lamb_weight_decay * p``, scaled by the
    trust ratio ``|p| / |r|``; ``exclude_from_weight_decay_fn(param)``
    turns the decay off per parameter."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lamb_wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _decay_enabled(self, name, param=None) -> bool:
        if self._exclude_fn is None:
            return True
        return not bool(self._exclude_fn(param))

    def _update(self, work, g, state, lr, step, decay=True):
        g32, p32 = g.float(), work.float()
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g32
        v = b2 * state["moment2"] + (1 - b2) * g32.square()
        m_hat = m / float(1 - _f32(b1) ** step)
        v_hat = v / float(1 - _f32(b2) ** step)
        wd = self._lamb_wd if decay else 0.0
        r = m_hat / (v_hat.sqrt() + self._eps) + wd * p32
        w_norm, r_norm = torch.linalg.norm(p32), torch.linalg.norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        state["moment1"].copy_(m)
        state["moment2"].copy_(v)
        return (p32 - float(lr) * trust * r).to(work.dtype)


class LarsMomentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, False,
                         name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay

    def _init_state(self, p):
        return {"velocity": _zeros(p)}

    def _update(self, work, g, state, lr, step, decay=True):
        g32, p32 = g.float(), work.float()
        w_norm, g_norm = torch.linalg.norm(p32), torch.linalg.norm(g32)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + 1e-12), 1.0)
        v = self._momentum * state["velocity"] + local_lr * float(lr) * (
            g32 + self._lars_wd * p32)
        state["velocity"].copy_(v)
        return (p32 - v).to(work.dtype)


class Rprop(Optimizer):
    """Resilient backprop: per-weight step sizes grown (``etas[1]``) or
    shrunk (``etas[0]``) by the sign agreement of successive gradients,
    within ``learning_rate_range``; a sign flip takes no step."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._eta_minus, self._eta_plus = etas
        self._lr_min, self._lr_max = learning_rate_range

    def _init_state(self, p):
        return {"prev_grad": _zeros(p),
                "step_size": torch.full(p.shape, self.get_lr(),
                                        dtype=torch.float32,
                                        device=p.device)}

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        sign = torch.sign(g32 * state["prev_grad"])
        grow = torch.where(sign > 0, self._eta_plus,
                           torch.where(sign < 0, self._eta_minus, 1.0))
        step_size = torch.clamp(state["step_size"] * grow, self._lr_min,
                                self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g32)
        state["prev_grad"].copy_(g_eff)
        state["step_size"].copy_(step_size)
        return (work.float() - torch.sign(g_eff) * step_size).to(work.dtype)


class NAdam(Adam):
    """Adam with Nesterov momentum and the reference's ``mu_t`` schedule
    (``momentum_decay``), the running product of the ``mu`` kept in the
    state (``mu_prod``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, **kwargs)
        self._psi = float(momentum_decay)

    def _init_state(self, p):
        st = super()._init_state(p)
        st["mu_prod"] = torch.ones((), dtype=torch.float32, device=p.device)
        return st

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        b1, psi = _f32(self._beta1), _f32(self._psi)
        mu_t = b1 * (1 - _f32(0.5) * _f32(0.96) ** (step * psi))
        mu_next = b1 * (1 - _f32(0.5) * _f32(0.96) ** ((step + 1) * psi))
        mu_prod = state["mu_prod"] * float(mu_t)
        m, v = self._moments(g32, state)
        m_hat = (float(mu_next) * m / (1 - mu_prod * float(mu_next))
                 + float(1 - mu_t) * g32 / (1 - mu_prod))
        v_hat = v / float(1 - _f32(self._beta2) ** step)
        new = work.float() - float(lr) * m_hat / (v_hat.sqrt() + self._eps)
        state["moment1"].copy_(m)
        state["moment2"].copy_(v)
        state["mu_prod"].copy_(mu_prod)
        return new.to(work.dtype)


class RAdam(Adam):
    """Rectified Adam: the adaptive term warmed up by the
    variance-rectification factor (plain momentum while ``rho_t <= 4``)."""

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        m, v = self._moments(g32, state)
        m_hat = m / float(1 - b1 ** step)
        # rho_inf in double, as the reference forms it from Python floats;
        # everything after it in f32
        rho_inf = 2.0 / (1 - self._beta2) - 1.0
        bt = b2 ** step
        rho_t = _f32(rho_inf) - _f32(2.0) * step * bt / (1 - bt)
        if rho_t > 4.0:
            r = np.sqrt((rho_t - 4) * (rho_t - 2) * _f32(rho_inf)
                        / max(_f32((rho_inf - 4) * (rho_inf - 2)) * rho_t,
                              _f32(1e-12)))
            v_hat = (v / float(1 - bt)).sqrt()
            delta = float(lr * r) * m_hat / (v_hat + self._eps)
        else:
            delta = float(lr) * m_hat
        state["moment1"].copy_(m)
        state["moment2"].copy_(v)
        return (work.float() - delta).to(work.dtype)


class ASGD(Optimizer):
    """Averaged SGD: ``d <- d - y + g``, ``y <- g``, ``p -= lr * d / n``
    with ``n = min(step, batch_num)``."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._batch_num = max(int(batch_num), 1)

    def _init_state(self, p):
        return {"d": _zeros(p), "y": _zeros(p)}

    def _update(self, work, g, state, lr, step, decay=True):
        g32 = g.float()
        d = state["d"] - state["y"] + g32
        n = max(min(step, _f32(self._batch_num)), _f32(1.0))
        state["d"].copy_(d)
        state["y"].copy_(g32)
        return (work.float() - float(lr) * d / float(n)).to(work.dtype)


class LBFGS(Optimizer):
    """L-BFGS driven by a closure (``step(closure)``: the closure clears
    the gradients, computes the loss, calls ``backward`` and returns the
    loss). The two-loop recursion over the last ``history_size`` (s, y)
    pairs runs on flattened f32 parameters; the curvature checks read
    scalars on the host, as the reference does."""

    def __init__(self, learning_rate=1.0, max_iter=1, history_size=10,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 parameters=None, line_search_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, None, False, name)
        self.max_iter = max_iter
        self.history_size = history_size
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self._hist = []  # (s, y, rho), flattened
        self._prev = None  # (flat params, flat grad)

    @staticmethod
    def _flat(ts):
        return torch.cat([t.detach().float().reshape(-1) for t in ts])

    def _direction(self, q):
        alphas = []
        for s, y, rho in reversed(self._hist):
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append(a)
        if self._hist:
            s, y, _ = self._hist[-1]
            q = q * (torch.dot(s, y) / torch.clamp_min(torch.dot(y, y),
                                                       1e-12))
        for (s, y, rho), a in zip(self._hist, reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        loss = None
        for _ in range(self.max_iter):
            loss = closure()
            params = [p for _, p in self._named if p.grad is not None]
            if not params:
                return loss
            flat_g = self._flat([p.grad for p in params])
            flat_p = self._flat(params)
            if float(flat_g.abs().max()) <= self.tol_grad:
                break
            if self._prev is not None:
                s = flat_p - self._prev[0]
                y = flat_g - self._prev[1]
                sy = float(torch.dot(s, y))
                if sy > 1e-10:
                    self._hist.append((s, y, 1.0 / sy))
                    if len(self._hist) > self.history_size:
                        self._hist.pop(0)
            self._prev = (flat_p, flat_g)
            step_vec = self.get_lr() * -self._direction(flat_g)
            if float(step_vec.abs().max()) <= self.tol_change:
                break
            new_flat = flat_p + step_vec
            off = 0
            with torch.no_grad():
                for p in params:
                    n = p.numel()
                    p.copy_(new_flat[off:off + n].reshape(p.shape))
                    off += n
        return loss

    def state_dict(self):
        out = super().state_dict()
        out["lbfgs_hist"] = [(s.clone(), y.clone(), r)
                             for s, y, r in self._hist]
        if self._prev is not None:
            out["lbfgs_prev"] = tuple(v.clone() for v in self._prev)
        return out

    def set_state_dict(self, state):
        super().set_state_dict(state)
        self._hist = [(torch.as_tensor(np.asarray(s)),
                       torch.as_tensor(np.asarray(y)), r)
                      for s, y, r in state.get("lbfgs_hist", [])]
        prev = state.get("lbfgs_prev")
        self._prev = (tuple(torch.as_tensor(np.asarray(v)) for v in prev)
                      if prev else None)
