"""The port's kernels: each hand-written Hopper kernel with its wrapper
and plain PyTorch version.

- K1 ``rms_norm`` and K6 ``rms_norm_bwd`` (csrc/rms_norm.cu), joined by
  ``RMSNormFunction``
- K2 ``paged_decode_attention`` (csrc/paged_attention.cu)
- K3 ``varlen_flash_attention`` forward (csrc/varlen_flash_attention.cu)
  and its backward ``varlen_flash_attention_bwd``
  (csrc/varlen_flash_attention_bwd.cu): one fused kernel K8
  (``varlen_flash_attention_bwd_fused``) for dq, dk and dv, on wgmma in
  bf16 and as 3xTF32 in f32 (``_dq`` and ``_dkv`` return its parts);
  joined by ``VarlenFlashAttentionFunction``; the segment logic they share is
  csrc/varlen_seg.cuh
- K4 ``flash_attention`` forward (csrc/flash_attention.cu) and its
  backward ``flash_attention_bwd`` (csrc/flash_attention_bwd.cu): one
  fused kernel K7 for dq, dk and dv, on wgmma in bf16 and as 3xTF32 in
  f32 (``flash_attention_bwd_dq`` and ``_dkv`` return its parts); joined
  by ``FlashAttentionFunction``
- K5 ``decode_attention`` (csrc/decode_attention.cu)
"""
from ._library import LAUNCHES, plain_versions, reset_launches
from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import (FlashAttentionFunction, flash_attention,
                              flash_attention_bwd, flash_attention_bwd_delta,
                              flash_attention_bwd_dkv, flash_attention_bwd_dq,
                              flash_attention_bwd_fused,
                              flash_attention_bwd_plain,
                              flash_attention_plain)
from .paged_attention import (paged_cache_write, paged_decode_attention,
                              paged_decode_attention_plain)
from .rms_norm import (RMSNormFunction, rms_norm, rms_norm_bwd,
                       rms_norm_bwd_plain, rms_norm_plain)
from .varlen_flash_attention import (VarlenFlashAttentionFunction,
                                     varlen_flash_attention,
                                     varlen_flash_attention_bwd,
                                     varlen_flash_attention_bwd_delta,
                                     varlen_flash_attention_bwd_dkv,
                                     varlen_flash_attention_bwd_dq,
                                     varlen_flash_attention_bwd_fused,
                                     varlen_flash_attention_bwd_plain,
                                     varlen_flash_attention_plain)

__all__ = [
    "LAUNCHES", "plain_versions", "reset_launches", "rms_norm",
    "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
    "RMSNormFunction", "paged_decode_attention",
    "paged_decode_attention_plain", "paged_cache_write",
    "varlen_flash_attention", "varlen_flash_attention_plain",
    "varlen_flash_attention_bwd", "varlen_flash_attention_bwd_dq",
    "varlen_flash_attention_bwd_dkv", "varlen_flash_attention_bwd_fused",
    "varlen_flash_attention_bwd_delta",
    "varlen_flash_attention_bwd_plain", "VarlenFlashAttentionFunction",
    "flash_attention", "flash_attention_plain", "flash_attention_bwd",
    "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
    "flash_attention_bwd_fused",
    "flash_attention_bwd_delta", "flash_attention_bwd_plain",
    "FlashAttentionFunction",
    "decode_attention", "decode_attention_plain",
]
