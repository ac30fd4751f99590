"""Inference entry points of the port (counterpart of
``paddle_tpu/inference``; this slice ports ``create_serving_engine``)."""
from __future__ import annotations

__all__ = ["create_serving_engine"]


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
    ``draft_pool``), ``device``
    (default ``cuda``; raises without CUDA unless ``"cpu"``). On the card
    the decode quantum (or the speculative round) runs as one captured
    CUDA graph; drive the engine
    with ``step()`` or with ``step_dispatch()`` / ``step_collect()``."""
    from ..serving import ServingEngine

    return ServingEngine(model, **kwargs)
