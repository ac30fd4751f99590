"""Rotary position embedding (counterpart of
``paddle_tpu/nn/functional/rope.py``).

Layout (batch, seq, heads, head_dim). ``neox=True`` rotates the pairs
(i, i + D/2) (Llama/NeoX); ``neox=False`` rotates adjacent lanes (GPT-J).
Angles and the rotation are computed in f32 and cast back, as in the
reference, so prefill (a table) and decode (angles on the fly) agree.
"""
from __future__ import annotations

import torch

__all__ = ["inv_freq", "build_rope_cache", "apply_rotary_emb",
           "fused_rotary_position_embedding"]


def inv_freq(head_dim, base=10000.0, device=None):
    """``1 / base ** (arange(0, D, 2) / D)`` in f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (base ** exps)


def build_rope_cache(seq_len, head_dim, base=10000.0, dtype=torch.float32,
                     position_offset=0, device=None):
    """Returns (cos, sin) of shape (seq_len, head_dim // 2).
    ``position_offset`` is an int or a 0-d integer tensor on ``device``."""
    pos = torch.arange(seq_len, dtype=torch.float32,
                       device=device) + position_offset
    freqs = torch.outer(pos, inv_freq(head_dim, base, device))
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rotary_emb(x, cos, sin, neox=True, position_ids=None):
    """x: (B, S, H, D); cos/sin: (S, D/2) or, with ``position_ids`` (B, S),
    a table indexed by them."""
    if position_ids is not None:
        cos = cos[position_ids][:, :, None, :]
        sin = sin[position_ids][:, :, None, :]
    else:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    cos = cos.float()
    sin = sin.float()
    xf = x.float()
    d = x.shape[-1]
    if neox:
        x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0,
                                    time_major=False):
    """``paddle.incubate.nn.functional.fused_rotary_position_embedding``:
    q / k / v (B, S, H, D), each rotated (``None`` passes through).
    Without ``sin`` / ``cos`` the table comes from ``rotary_emb_base``;
    given, they are paddle's (1, S, 1, D) with duplicated halves or
    (S, D/2). ``time_major`` is taken for the signature and, as in the
    reference, not read."""
    first = next(t for t in (q, k, v) if t is not None)
    s, d = first.shape[1], first.shape[3]
    if cos is None or sin is None:
        cos_a, sin_a = build_rope_cache(s, d, base=rotary_emb_base,
                                        device=first.device)
    else:
        # (1, S, 1, D) or (S, D): the reference reshapes by the last two
        # dims, which refuses paddle's 4-d layout its docstring promises
        cos_a = cos.reshape(-1, cos.shape[-1])
        sin_a = sin.reshape(-1, sin.shape[-1])
        if cos_a.shape[-1] == d:  # duplicated halves: take one
            cos_a, sin_a = cos_a[..., : d // 2], sin_a[..., : d // 2]
    return tuple(
        None if t is None else apply_rotary_emb(
            t, cos_a, sin_a, neox=use_neox_rotary_style,
            position_ids=position_ids)
        for t in (q, k, v))
