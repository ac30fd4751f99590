"""Models and serving caches of the port."""
from .convert import load_paddle_tpu_arrays, paddle_tpu_arrays_to_port
from .gpt import GPTBlock, GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel,
                    LlamaPretrainingCriterion, packed_position_ids)
from .paged_cache import PagedKVCachePool

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "packed_position_ids", "PagedKVCachePool",
           "GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM",
           "load_paddle_tpu_arrays", "paddle_tpu_arrays_to_port"]
