"""Chunked fused lm-head + softmax cross entropy (counterpart of
``paddle_tpu/incubate/nn/functional/fused_linear_cross_entropy.py``).

The forward walks the rows in chunks of ``chunk_rows``: per chunk it forms
the logits, adds the chunk's loss, and contracts the unscaled logits
gradient ``softmax - onehot`` (0 on ignored rows, cast to the hidden
states' dtype) into ``dh`` and an f32 ``dW``. The backward only scales
them by ``g / count``. Peak logits memory is ``chunk_rows * V`` instead of
``N * V``. The reference's products have no Pallas kernel (XLA runs
them); here they are cuBLAS / CPU matrix products. As in the reference
(``preferred_element_type=float32``), each chunk's logits and its ``dW``
product are formed in f32 from the operands in their own dtype: on CUDA
one bf16 product with an f32 output (``torch.mm(..., out_dtype=
torch.float32)``), elsewhere a product of operands upcast to f32 (exact:
a bf16 value is an f32 value). The ``dW`` products are summed in an f32
accumulator; ``dh`` is the product rounded to the hidden states' dtype.
"""
from __future__ import annotations

import torch

__all__ = ["fused_linear_cross_entropy"]


def _mm_f32(a, b):
    """``a @ b`` formed in f32 from operands of one dtype."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, weight, y, bias, chunk_rows, ignore_index):
        n, v = h.shape[0], weight.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.float32, device=h.device)
        dh = torch.empty_like(h)
        dw = torch.zeros(weight.shape, dtype=torch.float32, device=h.device)
        db = (torch.zeros(v, dtype=torch.float32, device=h.device)
              if bias is not None else None)
        for c0 in range(0, n, chunk_rows):
            hc, yc = h[c0:c0 + chunk_rows], y[c0:c0 + chunk_rows]
            logits = _mm_f32(hc, weight.t())
            if bias is not None:
                logits = logits + bias.float()
            lse = torch.logsumexp(logits, dim=-1)
            valid = yc != ignore_index
            safe = torch.where(valid, yc, 0)
            picked = logits.gather(-1, safe[:, None])[:, 0]
            total += torch.where(valid, lse - picked, 0.0).sum()
            count += valid.sum()
            p = torch.exp(logits - lse[:, None])
            p.scatter_add_(-1, safe[:, None],
                           torch.full_like(picked, -1.0)[:, None])
            p = torch.where(valid[:, None], p, 0.0)
            if db is not None:
                db += p.sum(dim=0)
            p = p.to(h.dtype)
            dh[c0:c0 + chunk_rows] = _mm_f32(p, weight)
            dw += _mm_f32(p.t(), hc)
        count = count.clamp_min(1.0)
        # the unscaled gradients are residuals of this op, not inputs
        ctx.grads = (dh, dw, db, count)
        ctx.dtypes = (weight.dtype, None if bias is None else bias.dtype)
        return total / count

    @staticmethod
    def backward(ctx, g):
        dh, dw, db, count = ctx.grads
        w_dtype, b_dtype = ctx.dtypes
        scale = (g / count).float()
        dbias = None if db is None else (db * scale).to(b_dtype)
        return (dh * scale.to(dh.dtype), (dw * scale).to(w_dtype), None,
                dbias, None, None)


def fused_linear_cross_entropy(hidden, weight, labels, bias=None,
                               ignore_index=-100, chunk_rows=1024):
    """Mean softmax cross entropy of ``hidden @ weight.T (+ bias)``
    against ``labels`` without materializing the full logits.

    ``hidden`` (..., H): final hidden states, any leading dims (flattened;
    typically already shifted, ``hidden[:, :-1]`` against
    ``labels[:, 1:]``). ``weight`` (V, H): the lm-head's weight in
    ``torch.nn.Linear``'s layout (the reference's (H, V) transposed).
    ``labels``: integer ids over ``hidden``'s leading dims; positions equal
    to ``ignore_index`` count neither in the sum nor in the mean's
    denominator. ``bias`` (V,) optional. Returns the f32 mean loss; its
    backward reaches ``hidden``, ``weight`` and ``bias``."""
    hd = hidden.shape[-1]
    h = hidden.reshape(-1, hd)
    y = labels.reshape(-1).long()
    if y.shape[0] != h.shape[0]:
        raise ValueError(
            f"labels {tuple(labels.shape)} do not match hidden "
            f"{tuple(hidden.shape)}")
    return _FusedLinearCrossEntropy.apply(h, weight, y, bias,
                                          int(chunk_rows), int(ignore_index))
