"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It imports torch and numpy only, never jax nor anything of ``paddle_tpu``.
Module paths mirror the reference's (``paddle_tpu_torch/nlp/llama.py`` is
the counterpart of ``paddle_tpu/nlp/llama.py``, and so on); the TPU
kernels of ``paddle_tpu/ops/pallas`` become hand-written CUDA kernels under
``paddle_tpu_torch/csrc`` with wrappers and plain PyTorch versions in
``paddle_tpu_torch/ops``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
from . import (amp, callbacks, distributed, framework, hapi, incubate,
               inference, io, jit, metric, nlp, nn, obs, ops, optimizer,
               peft, profiler, regularizer, serving, vision, visualdl)
from .framework import load, save
from .hapi import Model, flops, summary
from .inference import create_serving_engine
from .jit import JittedTrainStep
from .incubate.distributed.models.moe import MoELayer
from .incubate.nn import FusedMultiTransformer
from .nlp import (GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM,
                  LlamaPretrainingCriterion)
from .serving import ServingEngine

__version__ = "0.1.0"

__all__ = ["amp", "callbacks", "distributed", "framework", "hapi",
           "incubate", "inference", "io", "jit", "metric", "nlp", "nn",
           "obs", "ops", "optimizer", "peft", "profiler", "regularizer",
           "serving", "vision", "visualdl", "save", "load", "Model",
           "summary", "flops", "create_serving_engine", "LlamaConfig",
           "LlamaForCausalLM", "LlamaPretrainingCriterion", "GPTConfig",
           "GPTForCausalLM", "FusedMultiTransformer", "MoELayer",
           "JittedTrainStep", "ServingEngine"]
