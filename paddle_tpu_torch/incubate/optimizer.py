"""``paddle.incubate.optimizer`` (counterpart of
``paddle_tpu/incubate/optimizer.py``): ``LookAhead``, ``ModelAverage``
and ``ExponentialMovingAverage``, parameter-buffer transforms around an
optimizer's parameters. Their buffers are f32 tensors on the parameters'
devices, updated in place."""
from __future__ import annotations

import torch

__all__ = ["LookAhead", "ModelAverage", "ExponentialMovingAverage"]


class LookAhead:
    """k-step lookahead: every ``k`` inner steps the slow weights move
    ``alpha`` of the way to the fast weights and both take that value
    (the f32 master too, under ``multi_precision``)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step = 0
        self._slow = None

    def _params(self):
        return list(self.inner_optimizer._parameter_list)

    @torch.no_grad()
    def step(self):
        params = self._params()
        if self._slow is None:
            self._slow = [p.detach().clone() for p in params]
        self.inner_optimizer.step()
        self._step += 1
        if self._step % self.k == 0:
            states = self.inner_optimizer._states
            for p, s in zip(params, self._slow):
                s.copy_(s + self.alpha * (p - s))
                p.copy_(s)
                st = states.get(id(p))
                if st is not None and "master" in st:
                    st["master"].copy_(s.to(st["master"].dtype))

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        return {"inner": self.inner_optimizer.state_dict(),
                "step": self._step, "slow": self._slow}

    def set_state_dict(self, state):
        self.inner_optimizer.set_state_dict(state["inner"])
        self._step = state.get("step", 0)
        self._slow = state.get("slow")


class _AveragerBase:
    def __init__(self, parameters):
        # tensors, or (name, tensor) pairs
        self._params = [p[1] if isinstance(p, tuple) else p
                        for p in parameters]
        self._avg = None
        self._backup = None

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Swap the averaged weights in (evaluation); ``restore()`` undoes
        it."""
        if self._avg is None:
            return
        self._backup = ([p.detach().clone() for p in self._params]
                        if need_restore else None)
        for p, a in zip(self._params, self._avg):
            p.copy_(a.to(p.dtype))

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is not None:
            for p, b in zip(self._params, self._backup):
                p.copy_(b)
            self._backup = None


class ModelAverage(_AveragerBase):
    """The running mean of the parameters over every ``step()`` call (the
    window controls are taken for the reference's signature; its average
    is this running mean too)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        if parameters is None:
            raise ValueError(
                "ModelAverage requires parameters= (there is no global "
                "parameter registry to default to)")
        super().__init__(list(parameters))
        self._n = 0

    @torch.no_grad()
    def step(self):
        if self._avg is None:
            self._avg = [p.detach().float().clone() for p in self._params]
            self._n = 1
            return
        n = float(self._n)
        for a, p in zip(self._avg, self._params):
            a.copy_(a + (p.float() - a) / (n + 1))
        self._n += 1


class ExponentialMovingAverage(_AveragerBase):
    """EMA of the parameters: ``shadow = decay * shadow + (1 - decay) *
    param`` in f32."""

    def __init__(self, parameters, decay=0.999, name=None):
        super().__init__(list(parameters))
        self.decay = float(decay)

    @torch.no_grad()
    def update(self):
        if self._avg is None:
            self._avg = [p.detach().float().clone() for p in self._params]
            return
        for a, p in zip(self._avg, self._params):
            a.copy_(self.decay * a + (1 - self.decay) * p.float())

    step = update
