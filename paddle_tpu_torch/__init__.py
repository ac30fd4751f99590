"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It imports torch and numpy only, never jax nor anything of ``paddle_tpu``.
Module paths mirror the reference's (``paddle_tpu_torch/nlp/llama.py`` is
the counterpart of ``paddle_tpu/nlp/llama.py``, and so on); the TPU
kernels of ``paddle_tpu/ops/pallas`` become hand-written CUDA kernels under
``paddle_tpu_torch/csrc`` with wrappers and plain PyTorch versions in
``paddle_tpu_torch/ops``. ``import paddle_tpu_torch as paddle`` gives
paddle's top-level API: ``to_tensor``, the dtypes, places, seeds, the op
corpus, ``linalg``, ``nn.Layer``. Entry points run on the current place's
device, ``cuda`` unless ``set_device("cpu")`` (or ``device="cpu"``, or
``place=CPUPlace()``) asks for the CPU.
"""
# core
from .core.tensor import Tensor, Parameter, to_tensor
from .core.autograd import (no_grad, enable_grad, set_grad_enabled,
                            is_grad_enabled, grad)
from .core.dtype import (
    DType, dtype, bfloat16, float16, float32, float64, int8, int16, int32,
    int64, uint8, bool_ as bool8, complex64, complex128, float8_e4m3fn,
    float8_e5m2, get_default_dtype, set_default_dtype, finfo, iinfo,
)
from .core.place import (
    CPUPlace, TPUPlace, CUDAPlace, XPUPlace, CustomPlace, set_device,
    get_device, is_compiled_with_cuda, is_compiled_with_rocm,
    is_compiled_with_xpu, is_compiled_with_custom_device,
)
from .core.random import seed, get_rng_state, set_rng_state
from .core.flags import set_flags, get_flags
from .core.dispatch import OP_REGISTRY, apply, register_op

# the op corpus (also attaches paddle's tensor methods torch lacks)
from .tensor import *  # noqa: F401,F403
from . import tensor
from .tensor import linalg

from . import (amp, autograd, callbacks, device, distributed, fft,
               framework, hapi, incubate, inference, io, jit, metric, nlp,
               nn, obs, ops, optimizer, peft, profiler, regularizer, serving,
               signal, sparse, static, utils, vision, visualdl)
from .distributed.parallel import DataParallel
from .framework import load, save
from .hapi import Model, flops, summary
from .inference import create_serving_engine
from .jit import JittedTrainStep
from .incubate.distributed.models.moe import MoELayer
from .incubate.nn import FusedMultiTransformer
from .nlp import (GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM,
                  LlamaPretrainingCriterion)
from .nn.layer.layers import ParamAttr
from .optimizer.optimizer import L1Decay, L2Decay
from .serving import ServingEngine

# `paddle.bool` is the dtype; paddle shadows the builtin here and so do we
bool = bool8

__version__ = "0.1.0"


_static_mode = False


def disable_static():
    global _static_mode
    _static_mode = False


def enable_static():
    """Record static mode, as the reference does: ``in_dynamic_mode()``
    turns False. Ops still run eagerly; ``jit.to_static`` and
    ``static.save_inference_model(program=)`` build the programs."""
    global _static_mode
    _static_mode = True


def in_dynamic_mode():
    return not _static_mode


def device_count():
    import torch

    return torch.cuda.device_count()


def get_cudnn_version():
    import torch

    return (torch.backends.cudnn.version()
            if torch.backends.cudnn.is_available() else None)


class batch:
    """paddle.batch: wrap a sample reader into a batch reader (the legacy
    reader API)."""

    def __init__(self, reader, batch_size, drop_last=False):
        self.reader, self.batch_size, self.drop_last = (reader, batch_size,
                                                        drop_last)

    def __call__(self):
        buf = []
        for item in self.reader():
            buf.append(item)
            if len(buf) == self.batch_size:
                yield buf
                buf = []
        if buf and not self.drop_last:
            yield buf


from .core.dispatch import populate_op_registry as _populate  # noqa: E402

_populate()
