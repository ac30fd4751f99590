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
    ``eos_token_id``, ``device`` (default ``cuda``; raises without CUDA
    unless ``"cpu"``)."""
    from ..serving import ServingEngine

    return ServingEngine(model, **kwargs)
