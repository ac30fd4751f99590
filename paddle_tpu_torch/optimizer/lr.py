"""Learning-rate schedules (counterpart of ``paddle_tpu/optimizer/lr.py``;
the slice ports ``LRScheduler``, ``LinearWarmup`` and
``CosineAnnealingDecay``). Schedules are host-side state machines: the
optimizer reads ``scheduler()`` each step, and the caller steps the
schedule."""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "LinearWarmup", "CosineAnnealingDecay"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list, tuple))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a float, or a schedule stepped from 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = (learning_rate
                         if isinstance(learning_rate, LRScheduler) else None)
        self.warmup_steps = warmup_steps
        self.start_lr, self.end_lr = start_lr, end_lr
        base = (learning_rate.base_lr if self.lr_sched is not None
                else float(learning_rate))
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if self.lr_sched is not None:
            self.lr_sched.step(self.last_epoch - self.warmup_steps)
            return self.lr_sched()
        return self.base_lr

    def state_dict(self):
        d = super().state_dict()
        if self.lr_sched is not None:
            d["lr_sched"] = self.lr_sched.state_dict()
        return d

    def set_state_dict(self, state_dict):
        inner = state_dict.pop("lr_sched", None)
        if inner is not None and self.lr_sched is not None:
            self.lr_sched.set_state_dict(inner)
        self.__dict__.update(state_dict)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)
