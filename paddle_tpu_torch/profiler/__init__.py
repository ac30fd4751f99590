"""Training-step accounting of the port (counterpart of
``paddle_tpu/profiler``; the slice ports the MFU meter)."""
from .mfu import MFUMeter, peak_flops_per_chip, transformer_train_flops

__all__ = ["MFUMeter", "peak_flops_per_chip", "transformer_train_flops"]
