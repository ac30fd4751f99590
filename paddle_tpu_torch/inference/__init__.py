"""Inference entry points of the port (counterpart of
``paddle_tpu/inference``): ``create_serving_engine``, the serving front
door ``serve``, and the ``PrecisionType`` / ``PlaceType`` enums.
``Config``, ``Predictor`` and ``create_predictor`` need ``jit`` save and
load (ROADMAP A9): they raise."""
from __future__ import annotations

from .._later import not_ported

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


# they need jit save/load
Config = not_ported("paddle_tpu_torch.inference.Config", "A9")
Predictor = not_ported("paddle_tpu_torch.inference.Predictor", "A9")
create_predictor = not_ported("paddle_tpu_torch.inference.create_predictor",
                              "A9")


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
    the flight recorder, all on the host), ``device``
    (default ``cuda``; raises without CUDA unless ``"cpu"``). On the card
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
