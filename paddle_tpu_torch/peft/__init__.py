"""Parameter-efficient fine-tuning (counterpart of ``paddle_tpu/peft``).

LoRA is layer surgery: the base Linears stay frozen (``requires_grad``
off) in their dtype, the low-rank factors are small f32 parameters, and
the delta rides two extra products per wrapped Linear. The port's
``JittedTrainStep`` differentiates and updates only the trainable
parameters, so the optimizer holds state for the adapters alone.
"""
from .lora import (  # noqa: F401
    LoRAConfig, LoRALinear, LoRAModel, get_lora_model,
    mark_only_lora_as_trainable, lora_state_dict,
)

__all__ = [
    "LoRAConfig", "LoRALinear", "LoRAModel", "get_lora_model",
    "mark_only_lora_as_trainable", "lora_state_dict",
]
