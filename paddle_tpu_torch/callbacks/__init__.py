"""``paddle.callbacks`` of the port (the hapi callbacks under paddle's
second name)."""
from ..hapi.callbacks import (Callback, CallbackList, EarlyStopping,
                              LRScheduler, ModelCheckpoint, ProgBarLogger,
                              Terminate, VisualDL, config_callbacks)

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "Terminate", "VisualDL",
           "config_callbacks"]
