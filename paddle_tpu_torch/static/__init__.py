"""``paddle.static`` (counterpart of ``paddle_tpu/static/__init__.py``):
``InputSpec`` for ``jit.save``, ``Program`` handles as thin shims, and
``save_inference_model`` / ``load_inference_model`` / ``Executor`` over
``jit.save``'s artifacts.

``save_inference_model`` takes the reference's ``program=<Layer or
callable>`` mode: the program is exported on the feeds' specs (a dim of
``None`` or ``-1`` dynamic). The reference's other mode recovers the
feeds -> fetches computation from its eager tape after the fact; PyTorch
keeps no replayable record of an eager forward (its autograd graph holds
backward functions, not forward ones), and a recorder would cost every
eager op, so without ``program=`` the port refuses, naming ``program=``
(ROADMAP, deliberate differences).
"""
from __future__ import annotations

import json

import torch

from ..core.dtype import dtype as _dtype

__all__ = [
    "InputSpec", "Program", "Executor", "InferenceProgram",
    "default_main_program", "default_startup_program",
    "program_guard", "save_inference_model", "load_inference_model",
    "gradients",
]


class InputSpec:
    """Shape and dtype of an input (``None`` or ``-1``: a dynamic dim)."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = _dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape), tensor.dtype, name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(list(ndarray.shape), str(ndarray.dtype), name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


class Program:
    """Thin Program shim: the port builds no ProgramDesc; compiled
    StaticFunctions own their graphs (``jit.StaticFunction.lowered``)."""

    def __init__(self):
        self._ops = []

    def global_block(self):
        return self

    def clone(self, for_test=False):
        return self


_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


class program_guard:
    def __init__(self, main_program, startup_program=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Export an inference program: ``jit.save``'s artifacts
    (``{path_prefix}.pdmodel`` and ``.pdiparams``) and
    ``{path_prefix}.pdinfo.json`` (feed and fetch names).

    ``program=<Layer or callable>`` is exported on ``feed_vars`` (tensors
    or ``InputSpec``s; a dim of ``None`` / ``-1`` is dynamic) in eval mode
    without gradients (a Layer's mode is restored). Without ``program=``
    the port refuses: the reference rebuilds the program off its eager
    tape, and PyTorch keeps no replayable forward record."""
    from ..jit import save_program

    feed_vars = list(feed_vars) if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = list(fetch_vars) if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    if program is None:
        raise NotImplementedError(
            "save_inference_model without program=: the port cannot "
            "rebuild a program from an eager forward (PyTorch keeps no "
            "replayable record of one); pass program=<Layer or callable> "
            "with the feeds as InputSpecs or example tensors")
    layer = program if isinstance(program, torch.nn.Module) else None
    was_training = layer is not None and layer.training
    if layer is not None:
        layer.eval()
    try:
        save_program(program, path_prefix, feed_vars)
    finally:
        if was_training:
            layer.train()
    feed_names = [getattr(v, "name", None) or f"feed_{i}"
                  for i, v in enumerate(feed_vars)]
    fetch_names = [getattr(v, "name", None) or f"fetch_{i}"
                   for i, v in enumerate(fetch_vars)]
    with open(path_prefix + ".pdinfo.json", "w") as f:
        json.dump({"feed_names": feed_names, "fetch_names": fetch_names}, f)


class InferenceProgram:
    """A loaded inference program (over ``jit.load``'s layer): callable,
    and runnable by :class:`Executor`."""

    def __init__(self, layer, feed_names, fetch_names):
        self._layer = layer
        self.feed_names = feed_names
        self.fetch_names = fetch_names

    def __call__(self, *feeds):
        out = self._layer(*feeds)
        return list(out) if isinstance(out, list) else [out]

    def global_block(self):
        return self


def load_inference_model(path_prefix, executor=None, **kwargs):
    """``[program, feed_target_names, fetch_targets]``, as the reference
    returns them; run through ``Executor.run`` or call ``program``."""
    from ..jit import load

    with open(path_prefix + ".pdinfo.json") as f:
        info = json.load(f)
    prog = InferenceProgram(load(path_prefix), info["feed_names"],
                            info["fetch_names"])
    return [prog, prog.feed_names, prog.fetch_names]


class Executor:
    """Runs a program from :func:`load_inference_model` on named feeds."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None, **kwargs):
        if not isinstance(program, InferenceProgram):
            raise ValueError(
                "Executor.run expects a program from load_inference_model")
        feed = feed or {}
        outs = program(*[feed[name] for name in program.feed_names])
        if fetch_list is not None:
            picked = []
            for f in fetch_list:
                name = f if isinstance(f, str) else getattr(f, "name", None)
                if name not in program.fetch_names:
                    raise KeyError(
                        f"fetch {name!r} not in program fetches "
                        f"{program.fetch_names}")
                picked.append(outs[program.fetch_names.index(name)])
            outs = picked
        return [o.detach().float().cpu().numpy()
                if o.dtype in (torch.bfloat16, torch.float16)
                else o.detach().cpu().numpy() for o in outs]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    from ..core.autograd import grad

    return grad(targets, inputs, target_gradients, allow_unused=True)


from . import nn  # noqa: E402,F401
