"""The port's kernels: each hand-written Hopper kernel with its wrapper
and plain PyTorch version.

- K1 ``rms_norm`` (csrc/rms_norm.cu)
- K2 ``paged_decode_attention`` (csrc/paged_attention.cu)
- K3 ``varlen_flash_attention`` (csrc/varlen_flash_attention.cu)
- K4 ``flash_attention`` forward (csrc/flash_attention.cu)
- K5 ``decode_attention`` (csrc/decode_attention.cu)
"""
from ._library import LAUNCHES, plain_versions, reset_launches
from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import flash_attention, flash_attention_plain
from .paged_attention import (paged_cache_write, paged_decode_attention,
                              paged_decode_attention_plain)
from .rms_norm import rms_norm, rms_norm_plain
from .varlen_flash_attention import (varlen_flash_attention,
                                     varlen_flash_attention_plain)

__all__ = [
    "LAUNCHES", "plain_versions", "reset_launches", "rms_norm",
    "rms_norm_plain", "paged_decode_attention",
    "paged_decode_attention_plain", "paged_cache_write",
    "varlen_flash_attention", "varlen_flash_attention_plain",
    "flash_attention", "flash_attention_plain", "decode_attention",
    "decode_attention_plain",
]
