"""Models and serving caches of the port."""
from .convert import load_paddle_tpu_arrays
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)
from .paged_cache import PagedKVCachePool

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "PagedKVCachePool",
           "load_paddle_tpu_arrays"]
