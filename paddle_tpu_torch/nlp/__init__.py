"""Models and serving caches of the port."""
from .convert import load_paddle_tpu_arrays, paddle_tpu_arrays_to_port
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel,
                    LlamaPretrainingCriterion, packed_position_ids)
from .paged_cache import PagedKVCachePool

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "packed_position_ids", "PagedKVCachePool",
           "load_paddle_tpu_arrays", "paddle_tpu_arrays_to_port"]
