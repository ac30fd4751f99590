"""Seeds and generator state on torch's generators.

The reference threads JAX PRNG keys off one global ``Generator``
(``paddle_tpu/core/random.py``). Here ``seed`` seeds torch's CPU and CUDA
generators (``torch.manual_seed``), and the random ops draw from them on
their tensor's device. The draws are torch's, not threefry's.
``get_rng_state`` / ``set_rng_state`` save and restore every generator:
the CPU's, then each CUDA device's where CUDA is available.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Generator", "seed", "default_generator", "get_rng_state",
           "set_rng_state", "RNGStatesTracker", "get_rng_state_tracker"]


class Generator(torch.Generator):
    """paddle.Generator: a torch generator seeded at construction (from the
    clock when no seed is given)."""

    def __new__(cls, seed_=None, device="cpu"):
        g = super().__new__(cls, device=device)
        g.manual_seed(time.time_ns() % (2 ** 31) if seed_ is None
                      else int(seed_))
        return g

    def __init__(self, seed_=None, device="cpu"):
        pass


default_generator = torch.default_generator


def seed(value: int):
    """paddle.seed(v): seed the CPU generator and every CUDA device's;
    returns the CPU generator."""
    return torch.manual_seed(int(value))


def get_rng_state():
    """Every generator's state: the CPU's, then each CUDA device's."""
    states = [torch.get_rng_state()]
    if torch.cuda.is_available():
        states += torch.cuda.get_rng_state_all()
    return states


def set_rng_state(state):
    torch.set_rng_state(state[0])
    if len(state) > 1:
        torch.cuda.set_rng_state_all(state[1:])


def _seeded_states(seed_):
    saved = get_rng_state()
    try:
        torch.manual_seed(int(seed_))
        return get_rng_state()
    finally:
        set_rng_state(saved)


class RNGStatesTracker:
    """Named generator states for tensor-parallel dropout (the reference's
    ``fleet.meta_parallel.get_rng_state_tracker``): inside
    ``rng_state(name)`` torch's generators draw from that name's stream,
    which advances, and the surrounding state comes back on exit."""

    def __init__(self):
        self._states: dict = {}

    def add(self, name: str, seed_: int):
        if name in self._states:
            raise ValueError(f"rng state {name} already exists")
        self._states[name] = _seeded_states(seed_)

    def reset(self):
        self._states = {}

    def states(self):
        return dict(self._states)

    def set_states(self, states):
        self._states = dict(states)

    class _Scope:
        def __init__(self, tracker, name):
            self.tracker, self.name = tracker, name

        def __enter__(self):
            self._saved = get_rng_state()
            set_rng_state(self.tracker._states[self.name])
            return self

        def __exit__(self, *exc):
            self.tracker._states[self.name] = get_rng_state()
            set_rng_state(self._saved)
            return False

    def rng_state(self, name: str = "global_seed"):
        if name not in self._states:
            self.add(name, np.random.randint(0, 2 ** 31))
        return RNGStatesTracker._Scope(self, name)


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker
