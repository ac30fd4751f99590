"""Models and serving caches of the port."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel,
                   BertPretrainingCriterion, ErnieConfig, ErnieForPretraining,
                   ErnieModel)
from .convert import load_paddle_tpu_arrays, paddle_tpu_arrays_to_port
from .gpt import GPTBlock, GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel,
                    LlamaPretrainingCriterion, packed_position_ids)
from .paged_cache import PagedKVCachePool
from .t5 import T5Config, T5ForConditionalGeneration, T5Model

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "packed_position_ids", "PagedKVCachePool",
           "GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM",
           "BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "BertPretrainingCriterion",
           "ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "T5Config", "T5Model", "T5ForConditionalGeneration",
           "load_paddle_tpu_arrays", "paddle_tpu_arrays_to_port"]
