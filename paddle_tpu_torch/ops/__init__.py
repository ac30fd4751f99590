"""The port's kernels: each hand-written Hopper kernel with its wrapper
and plain PyTorch version.

- K1 ``rms_norm`` (csrc/rms_norm.cu)
- K2 ``paged_decode_attention`` (csrc/paged_attention.cu)
- K3 ``varlen_flash_attention`` (csrc/varlen_flash_attention.cu)
"""
from ._library import LAUNCHES, plain_versions, reset_launches
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
]
