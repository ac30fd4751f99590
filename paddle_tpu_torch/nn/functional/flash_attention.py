"""``paddle.nn.functional.flash_attention``, the submodule (counterpart of
``paddle_tpu/nn/functional/flash_attention.py``): the attention
functionals under this path too, and :func:`flash_attn_qkvpacked`."""
from .attention import (flash_attention, flash_attn_unpadded,  # noqa: F401
                        scaled_dot_product_attention)

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "flash_attn_qkvpacked"]


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         fixed_seed_offset=None, rng_name="", training=True,
                         name=None, generator=None):
    """Flash attention over packed (B, S, 3, H, D) queries, keys and
    values; returns ``(out, None)``. Each of the three is made contiguous
    for the kernels (K4 forward, K7 backward on CUDA tensors); autograd
    gathers their gradients back into qkv's layout."""
    q, k, v = (t.contiguous() for t in qkv.unbind(2))
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training,
                           generator=generator)
