"""Optimizers, schedules and clipping of the port (counterpart of
``paddle_tpu/optimizer``)."""
from . import lr
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue)
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                        AdamW, L1Decay, L2Decay, Lamb, LarsMomentum,
                        Momentum, NAdam, Optimizer, RAdam, RMSProp, Rprop)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum",
           "Rprop", "NAdam", "RAdam", "ASGD", "LBFGS", "L1Decay", "L2Decay",
           "ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
