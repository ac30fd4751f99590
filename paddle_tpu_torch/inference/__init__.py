"""Inference entry points of the port (counterpart of
``paddle_tpu/inference``): the ``Config`` / ``Predictor`` /
``create_predictor`` deployment API over ``jit.save``'s artifacts,
``create_serving_engine``, the serving front door ``serve``, and the
``PrecisionType`` / ``PlaceType`` enums.

A ``Predictor`` loads ``prefix.pdmodel`` / ``prefix.pdiparams``
(``jit.load``) and runs the exported program on the device it was saved
from; its zero-copy handles hold device tensors. ``clone()`` shares the
program and the weights and gets fresh handles. The C inference API
(``paddle_tpu_torch/csrc/capi/``, built by :mod:`.capi`) drives this
module from an embedded interpreter."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Config", "Predictor", "create_predictor", "PrecisionType",
           "PlaceType", "create_serving_engine", "serve"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM = 3
    TPU = 4


class Config:
    """``paddle.inference.Config``: ``Config(prefix)`` or
    ``Config(model_file, params_file)``. The tuning knobs (every
    ``enable_*`` / ``set_*`` / ``switch_*`` / ``disable_*``) are accepted
    and recorded in ``ignored_options``: the exported program runs as
    saved."""

    def __init__(self, prog_file=None, params_file=None):
        self._prefix = None
        self._params_file = None if params_file is None else str(params_file)
        if prog_file is not None:
            self.set_prog_file(prog_file)
        self.ignored_options = []

    def set_prog_file(self, path):
        p = str(path)
        self._prefix = p[:-len(".pdmodel")] if p.endswith(".pdmodel") else p

    def set_params_file(self, path):
        self._params_file = str(path)

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def params_file(self):
        return self._params_file or (self._prefix or "") + ".pdiparams"

    def __getattr__(self, name):
        # accept and record every tuning knob
        if name.startswith(("enable_", "set_", "switch_", "disable_")):
            def sink(*a, **k):
                self.ignored_options.append(name)
            return sink
        raise AttributeError(name)


class _Handle:
    """A zero-copy tensor handle: it holds a tensor on the predictor's
    device."""

    def __init__(self, device=None):
        self._value = None
        self._device = device

    def copy_from_cpu(self, arr):
        t = torch.tensor(np.asarray(arr))
        self._value = t.to(self._device) if self._device is not None else t

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(tuple(shape))

    def copy_to_cpu(self):
        t = self._value.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()  # numpy has no bfloat16
        return t.cpu().numpy()

    def shape(self):
        return list(self._value.shape) if self._value is not None else []


class Predictor:
    """``paddle_infer::Predictor`` over a ``jit.save`` artifact."""

    def __init__(self, config: Config):
        from ..jit import load

        self._layer = load(config._prefix, params_path=config.params_file())
        self._inputs = {f"input_{i}": _Handle(self._layer._device)
                        for i in range(self._layer._n_inputs)}
        self._outputs = {}

    def get_input_names(self):
        return list(self._inputs)

    def get_input_handle(self, name):
        return self._inputs[name]

    def run(self, inputs=None):
        """``Predictor::Run``. With ``inputs`` (a list of arrays or
        tensors) returns the outputs as numpy arrays; else reads the input
        handles and fills the output handles."""
        vals = list(inputs) if inputs is not None else [
            h._value for h in self._inputs.values()]
        out = self._layer(*vals)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = {}
        for i, o in enumerate(outs):
            h = _Handle(self._layer._device)
            h._value = o
            self._outputs[f"output_{i}"] = h
        if inputs is not None:
            return [h.copy_to_cpu() for h in self._outputs.values()]
        return True

    def get_output_names(self):
        return list(self._outputs)

    def get_output_handle(self, name):
        return self._outputs[name]

    def clone(self):
        """A predictor for another thread (``AnalysisPredictor::Clone``):
        the program and weights are shared, the handles are its own."""
        new = object.__new__(Predictor)
        new._layer = self._layer
        new._inputs = {name: _Handle(self._layer._device)
                       for name in self._inputs}
        new._outputs = {}
        return new


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def create_serving_engine(model, **kwargs):
    """Continuous-batching entry point: wrap a causal LM in a
    :class:`~paddle_tpu_torch.serving.ServingEngine` (shared paged KV
    pool, chunked mixed prefill, decode quantum). Keyword arguments go to
    the engine: ``num_slots``, ``block_size``, ``num_blocks``,
    ``max_context``, ``prefill_chunk``, ``decode_quantum``,
    ``decode_strategy`` (``"greedy"`` or ``"sampling"`` with ``top_k``,
    ``top_p``, ``temperature``, ``per_request_sampling``),
    ``eos_token_id``, ``quantize`` (``"weight_only_int8"`` or
    ``"llm.int8"``: the model's Linears swept IN PLACE to int8 weights
    with per-channel scales), ``kv_dtype`` (``"int8"``: int8 KV pools
    with per-row scale pools), ``multi_quantum`` (K > 1: up to K decode
    quanta per dispatch in steady state; on the card it saves host
    syncs only), ``attn_impl`` (``"gather"`` or ``"fused"``, for parity
    with the reference: both launch K2 on the card, so it changes nothing
    there; on the CPU ``"fused"`` runs the online-softmax port of the
    reference's block stream), ``prefix_cache`` (``True``: requests that
    share full prompt blocks with a published prompt alias those blocks
    and skip their prefill, and a write into a shared block copies it
    first; on the card the copy runs in place on the current stream, so
    the captured quantum keeps its pool addresses and its replay sees the
    copy; ``engine_stats()["prefix_cache"]`` has the hits, misses, copies
    and evictions), ``spec_draft`` (a draft causal LM of the same vocab:
    the decode dispatch becomes the speculative round, the draft's
    ``spec_gamma`` proposals (default 4) over its own paged pool, the
    target's verify of all γ+1 positions in one chunked forward, and
    acceptance on the device, one host sync a round; greedy streams equal
    the target's own, sampling is rejection sampling, exact in
    distribution; ``engine_stats()`` gains ``spec_rounds``,
    ``spec_proposed``, ``spec_accepted``, ``spec_acceptance_rate`` and
    ``draft_pool``), ``obs`` / ``trace`` / ``slo`` / ``flight`` (the
    metrics registry, a Chrome trace, the SLOs behind ``health()`` and
    the flight recorder, all on the host), ``faults`` / ``resilience``
    (a seeded :class:`~paddle_tpu_torch.serving.FaultInjector`, and
    ``True`` or a :class:`~paddle_tpu_torch.serving.ResiliencePolicy`:
    retries, step skips, the poison bisect, the watchdog, the speculative
    fall-back, cached-prefix checksums; snapshot / restore come with every
    engine), ``device`` (default ``cuda``; raises without CUDA unless
    ``"cpu"``). On the card
    the decode quantum (or the speculative round) runs as one captured
    CUDA graph; drive the engine
    with ``step()`` or with ``step_dispatch()`` / ``step_collect()``."""
    from ..serving import ServingEngine

    return ServingEngine(model, **kwargs)


def serve(model, policy=None, slo=True, flight=True, device=None, **kwargs):
    """The serving front door: build a
    :class:`~paddle_tpu_torch.serving.ServingEngine` and wrap it in a
    :class:`~paddle_tpu_torch.serving.ServingFrontDoor`: token-by-token
    streams (sync, or ``async for`` under ``run_async()``), per-request
    parameters, priority classes with preemption under pool pressure
    (recompute-on-resume, the continuation equal to an undisturbed
    run's), SLO burn-rate load shedding and queue backpressure
    (``policy=`` a :class:`~paddle_tpu_torch.serving.FrontDoorPolicy`),
    and graceful ``drain()``.

    ``slo`` and ``flight`` default on (shedding reads the health report;
    drain flushes the journals). ``decode_strategy="sampling"`` turns on
    ``per_request_sampling`` so ``submit(..., temperature=)`` works per
    request. Other keyword arguments go to the engine
    (:func:`create_serving_engine` lists them); ``device`` defaults to
    ``cuda`` and raises without CUDA unless ``"cpu"``.

    On the card the first pump builds the kernels and captures the
    decode quantum: that wall lands in the first requests' time to first
    token and burns the stock 0.5 s objective, so the stock policy then
    sheds NORMAL and BATCH traffic. Warm the engine before a shedding
    run, or pass ``policy=no_shed_policy()`` for a deterministic drive.

    ::

        fd = serve(model, num_slots=8, eos_token_id=2)
        stream = fd.submit(prompt, priority=INTERACTIVE,
                           max_new_tokens=128)
        for tok in stream:          # pumps the engine as it pulls
            ...
        fd.drain("flight.jsonl")    # stop admitting, finish, flush
    """
    from ..serving import ServingEngine, ServingFrontDoor

    if kwargs.get("decode_strategy") == "sampling":
        kwargs.setdefault("per_request_sampling", True)
    engine = ServingEngine(model, slo=slo, flight=flight, device=device,
                           **kwargs)
    return ServingFrontDoor(engine, policy=policy)
