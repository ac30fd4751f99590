"""``paddle.jit`` on TorchDynamo and ``torch.export`` (counterpart of
``paddle_tpu/jit/__init__.py``, which traces with ``jax.jit``).

- :func:`to_static` wraps a function or a Layer's forward in a
  :class:`StaticFunction` that compiles it with ``torch.compile``. The
  reference's value guards (a ``bool()`` on a tensor breaks the graph, the
  call runs eagerly, a specialization is kept per observed outcome and
  checked on later calls) are Dynamo's graph breaks and guards: Dynamo
  compiles the code before the branch, evaluates the branch in Python and
  resumes in a compiled continuation, and it recompiles on a new shape or
  dtype. The reference's ``_MAX_GUARD_SPECS`` is Dynamo's recompile limit,
  per function (each StaticFunction compiles its own copy of the
  function's code), after which the function runs eagerly, as the
  reference's does. The kernels K1 / K6, K3 / K8 and K4 / K7 are custom
  ops (``ops/_library.py``), so a graph holds their calls; K2 and K5
  refuse to be traced.
- :func:`save` writes ``path.pdmodel`` (a ``torch.export`` program whose
  inputs are the layer's inputs, then its parameters and buffers) and
  ``path.pdiparams`` (those parameters and buffers, the input count and
  the device); :func:`load` gives a :class:`TranslatedLayer`. An
  ``InputSpec`` dim of ``None`` or ``-1`` becomes a dynamic
  ``torch.export.Dim``. The artifacts are torch's, not the reference's
  (ROADMAP, deliberate differences).

Backends: ``backend=None`` compiles with inductor where the call's
tensors lie on the card and with ``aot_eager`` (AOTAutograd's graphs run
op by op, no code generation) on the CPU, where inductor generates and
compiles C++ for every graph; ``"CINN"`` (paddle's compiler) means inductor;
any other name is a ``torch.compile`` backend. Nothing falls back: a
kernel that fails inside a compiled graph raises.
"""
from __future__ import annotations

import io
import os
import types

import numpy as np
import torch

from .train import JittedTrainStep

__all__ = [
    "to_static", "not_to_static", "ignore_module", "save", "load",
    "functional_call", "TranslatedLayer", "enable_to_static",
    "JittedTrainStep",
]

_to_static_enabled = True
# the reference's bound on value specializations per function; here
# Dynamo's recompile limit (``torch._dynamo.config.recompile_limit``, 8 by
# default), which counts per code object: each StaticFunction's own
_MAX_GUARD_SPECS = 8


def enable_to_static(flag=True):
    global _to_static_enabled
    _to_static_enabled = bool(flag)


class _Call(torch.nn.Module):
    """``fn`` over ``layer`` as a module: its output and the layer's
    buffers after the call."""

    def __init__(self, layer, fn):
        super().__init__()
        self.layer = layer
        object.__setattr__(self, "fn", fn)

    def forward(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        return out, [b for _, b in self.layer.named_buffers()]


def functional_call(layer, fn, args, kwargs, param_values, buffer_values):
    """Run ``fn`` with the layer's parameters and buffers (in
    ``named_parameters()`` / ``named_buffers()`` order) rebound to the
    given tensors (``torch.func.functional_call``); returns ``(output,
    new_buffer_values)``."""
    values = {f"layer.{n}": v for (n, _), v in
              zip(layer.named_parameters(), param_values)}
    values.update({f"layer.{n}": v for (n, _), v in
                   zip(layer.named_buffers(), buffer_values)})
    return torch.func.functional_call(_Call(layer, fn), values, tuple(args),
                                      dict(kwargs))


def _own_code(fn):
    """``fn`` over a copy of its code object: Dynamo keeps its cache and
    counts recompiles per code object, so each StaticFunction gets its own
    guard cache and its own recompile limit (the reference's per-function
    specializations)."""
    self_ = getattr(fn, "__self__", None)
    f = getattr(fn, "__func__", fn)
    if not isinstance(f, types.FunctionType):
        return fn
    g = types.FunctionType(f.__code__.replace(), f.__globals__, f.__name__,
                           f.__defaults__, f.__closure__)
    g.__kwdefaults__ = f.__kwdefaults__
    g.__qualname__, g.__module__ = f.__qualname__, f.__module__
    return types.MethodType(g, self_) if self_ is not None else g


def _backend_name(backend, device_type):
    if backend is None:
        return "inductor" if device_type == "cuda" else "aot_eager"
    if isinstance(backend, str) and backend.upper() == "CINN":
        return "inductor"
    return backend


def _call_device(args, kwargs, layer):
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device.type
    if layer is not None:
        for p in layer.parameters():
            return p.device.type
    return "cpu"


class StaticFunction:
    """What ``to_static`` returns for a function or a Layer's forward.

    ``graphs`` holds every FX graph Dynamo handed the backend (a retrace
    on a new shape adds one, a graph break splits a call into several),
    ``graph_breaks`` the reasons Dynamo could not keep ``full_graph``."""

    def __init__(self, function, layer=None, input_spec=None,
                 build_strategy=None, backend=None, full_graph=True):
        self._function = function
        self._layer = layer
        self._input_spec = input_spec
        self._backend = backend
        self._full_graph = bool(full_graph)
        self._compiled = {}
        self.graphs = []
        self.graph_breaks = []
        self.__name__ = getattr(function, "__name__", "forward")

    def __get__(self, instance, owner):
        # a class-level @to_static binds like a method
        if instance is None:
            return self
        return types.MethodType(self, instance)

    def _get_layer(self, args):
        if self._layer is not None:
            return self._layer, self._function, args
        fn = self._function
        if isinstance(getattr(fn, "__self__", None), torch.nn.Module):
            return fn.__self__, fn, args
        if args and isinstance(args[0], torch.nn.Module):
            return args[0], fn.__get__(args[0]), args[1:]
        return None, fn, args

    def _compile(self, name, fullgraph):
        graphs = self.graphs

        def backend(gm, example_inputs):
            graphs.append(gm)
            return torch._dynamo.lookup_backend(name)(gm, example_inputs)

        return torch.compile(_own_code(self._function), backend=backend,
                             fullgraph=fullgraph)

    def __call__(self, *args, **kwargs):
        layer, fn, call_args = self._get_layer(args)
        if not _to_static_enabled or torch.compiler.is_compiling():
            # disabled, or nested inside an enclosing trace (Dynamo
            # inlines it into the enclosing graph)
            return fn(*call_args, **kwargs)
        # the compiled function is ``self._function``: it takes ``args``
        call_args = tuple(_as_tensor(a) for a in args)
        name = _backend_name(self._backend,
                             _call_device(call_args, kwargs, layer))
        entry = self._compiled.get(name)
        if entry is None:
            entry = self._compiled[name] = [
                self._compile(name, self._full_graph), self._full_graph]
        if not entry[1]:
            return entry[0](*call_args, **kwargs)
        try:
            return entry[0](*call_args, **kwargs)
        except torch._dynamo.exc.Unsupported as e:
            # a value branch or a call Dynamo cannot trace: the reference
            # breaks its graph there (its value guards); record why and
            # compile with graph breaks from now on
            self.graph_breaks.append(str(e).splitlines()[0])
            entry[:] = [self._compile(name, False), False]
            return entry[0](*call_args, **kwargs)

    # -- introspection ------------------------------------------------------
    def concrete_program(self, *args):
        return None

    def lowered(self, *args, **kwargs):
        """The last FX graph Dynamo captured for this function (compiling
        a call on ``args`` first when none was captured): the counterpart
        of the reference's ``jax.stages.Lowered``."""
        if not self.graphs:
            self(*args, **kwargs)
        return self.graphs[-1]

    def get_stablehlo(self, *args, **kwargs):
        """The captured graph's text (the reference returns StableHLO;
        here it is the FX graph's Python code, the custom ops' calls
        named ``torch.ops.paddle_tpu_torch.*``)."""
        return self.lowered(*args, **kwargs).print_readable(
            print_output=False)


def _as_tensor(a):
    if isinstance(a, np.ndarray):
        from ..core.tensor import to_tensor

        return to_tensor(a)
    return a


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """Decorator or wrapper: ``paddle.jit.to_static``. On a Layer, its
    forward becomes a :class:`StaticFunction` and the Layer is returned.
    ``full_graph`` asks Dynamo for one graph; where the function branches
    on a tensor's value (the reference's graph break), the StaticFunction
    records the reason in ``graph_breaks`` and compiles with breaks."""

    def decorate(obj):
        if isinstance(obj, torch.nn.Module):
            obj.forward = StaticFunction(
                obj.forward, layer=obj, input_spec=input_spec,
                build_strategy=build_strategy, backend=backend,
                full_graph=full_graph)
            return obj
        return StaticFunction(obj, input_spec=input_spec,
                              build_strategy=build_strategy, backend=backend,
                              full_graph=full_graph)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    """Keep ``fn`` out of compiled graphs: it runs as Python
    (``torch.compiler.disable``; a graph break where it is called)."""
    fn._not_to_static = True
    out = torch.compiler.disable(fn)
    out._not_to_static = True
    return out


def ignore_module(modules):
    """Nothing to do: the reference records nothing here either."""


class TranslatedLayer:
    """The inference layer :func:`load` rebuilds from an exported program:
    calling it runs the program on its inputs (moved to the program's
    device) and the loaded parameters. One output comes back as a
    tensor, several as a list."""

    def __init__(self, exported, params, n_inputs=None, device=None):
        self._exported = exported
        self._module = exported.module()
        self._params = list(params)
        n_user = sum(1 for s in exported.graph_signature.input_specs
                     if s.kind == torch.export.graph_signature.InputKind
                     .USER_INPUT)
        self._n_inputs = (n_inputs if n_inputs is not None
                          else n_user - len(self._params))
        self._device = device if device is not None else (
            self._params[0].device if self._params else None)

    def __call__(self, *args):
        vals = [_input_tensor(a, self._device) for a in args]
        with torch.no_grad():
            out = self._module(*vals, *self._params)
        if isinstance(out, (list, tuple)):
            outs = list(out)
            return outs[0] if len(outs) == 1 else outs
        return out

    def forward(self, *args):
        return self(*args)

    def eval(self):
        return self


def _input_tensor(a, device):
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device) if device is not None else a


class _Program(torch.nn.Module):
    """The exported function: ``fwd`` on ``n`` inputs with the layer's
    parameters and buffers (when there is a layer) rebound to the
    remaining inputs. The layer is held outside the module's registry,
    so the program owns no state."""

    def __init__(self, layer, fwd, names, n):
        super().__init__()
        object.__setattr__(self, "_layer", layer)
        object.__setattr__(self, "_fwd", fwd)
        self._names, self._n = names, n

    def forward(self, *flat):
        from torch.nn.utils.stateless import _reparametrize_module

        if self._layer is None:
            out = self._fwd(*flat)
        else:
            with _reparametrize_module(
                    self._layer, dict(zip(self._names, flat[self._n:]))):
                out = self._fwd(*flat[:self._n])
        return tuple(torch.utils._pytree.tree_leaves(out))


def _examples(input_spec, device):
    """Example inputs and dynamic shapes for the specs: a dim of None or
    -1 becomes ``Dim.DYNAMIC`` with an example size of 2, 3, ... in spec
    order (distinct, so export relates no two of them by chance)."""
    from ..static import InputSpec

    examples, dynamic, n_dyn = [], [], 0
    for spec in input_spec:
        if isinstance(spec, InputSpec):
            shape, dims = [], {}
            for i, s in enumerate(spec.shape):
                if s is None or s < 0:
                    shape.append(2 + n_dyn)
                    dims[i] = torch.export.Dim.DYNAMIC
                    n_dyn += 1
                else:
                    shape.append(int(s))
            examples.append(torch.zeros(shape, dtype=spec.dtype,
                                        device=device))
            dynamic.append(dims or None)
        elif isinstance(spec, torch.Tensor):
            examples.append(spec.detach().to(device))
            dynamic.append(None)
        else:
            examples.append(torch.as_tensor(np.asarray(spec), device=device))
            dynamic.append(None)
    return examples, dynamic


def export_program(program, input_spec):
    """``(ExportedProgram, tensors, device)``: ``program`` (a Layer's
    forward, or a callable of the inputs) exported on ``input_spec``
    without gradients; the program's inputs are the specs' tensors, then
    the layer's parameters and buffers (``tensors``), on the layer's
    device (else the first example tensor's, else the CPU)."""
    layer = program if isinstance(program, torch.nn.Module) else None
    named = (list(layer.named_parameters()) + list(layer.named_buffers())
             if layer is not None else [])
    tensors = [t.detach() for _, t in named]
    device = next((t.device for t in tensors), None) or next(
        (t.device for t in input_spec if isinstance(t, torch.Tensor)),
        torch.device("cpu"))
    examples, dynamic = _examples(input_spec, device)
    fwd = layer.forward if layer is not None else program
    if isinstance(fwd, StaticFunction):
        fwd = fwd._function
    prog = _Program(layer, fwd, [n for n, _ in named], len(examples))
    with torch.no_grad():
        ep = torch.export.export(
            prog, tuple(examples + tensors),
            dynamic_shapes=(tuple(dynamic + [None] * len(tensors)),),
            strict=False)
    return ep, tensors, device


def save_program(program, path, input_spec):
    """Export ``program`` (:func:`export_program`) and write
    ``path.pdmodel`` and ``path.pdiparams``."""
    ep, tensors, device = export_program(program, input_spec)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_program(ep, path + ".pdmodel")
    torch.save({"n_inputs": len(input_spec), "tensors": tensors,
                "device": str(device)}, path + ".pdiparams")


def write_program(exported, path):
    """Write an ``ExportedProgram`` to ``path`` (torch's archive format,
    under paddle's file name)."""
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def read_program(path):
    """The ``ExportedProgram`` :func:`write_program` wrote; the kernels'
    custom ops are registered first."""
    from .. import ops  # noqa: F401

    with open(path, "rb") as f:
        return torch.export.load(io.BytesIO(f.read()))


def save(layer, path, input_spec=None, **configs):
    """``paddle.jit.save``: ``path.pdmodel`` (the ``torch.export``
    program) and ``path.pdiparams`` (parameters and buffers, the input
    count and the device, by ``torch.save``). The layer is left in eval
    mode, as the reference leaves it."""
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer")
    if input_spec is None:
        raise ValueError("jit.save requires input_spec on this backend")
    layer.eval()
    save_program(layer, path, input_spec)


def load(path, params_path=None, **configs):
    """``paddle.jit.load`` -> :class:`TranslatedLayer`; the parameters go
    to the device the program was saved from."""
    exported = read_program(path + ".pdmodel")
    blob = torch.load(params_path or path + ".pdiparams",
                      map_location="cpu", weights_only=True)
    dev = torch.device(blob["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was saved from {dev}, and CUDA is not "
                           f"available")
    params = [t.to(dev) for t in blob["tensors"]]
    return TranslatedLayer(exported, params, n_inputs=blob["n_inputs"],
                           device=dev)

