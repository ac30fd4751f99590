"""Search and sort ops (the reference's ``paddle_tpu/tensor/search.py``)
on torch. Indices are int64, paddle's index dtype (the reference, with
JAX's 64-bit mode off, returns int32)."""
from __future__ import annotations

import torch

from ._helpers import ensure_tensor, to_torch_dtype

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "nonzero",
    "index_select", "masked_select", "searchsorted", "kthvalue", "mode",
    "median", "nanmedian", "quantile", "nanquantile", "bucketize",
]


def _arg(tfn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        x = ensure_tensor(x)
        dt = to_torch_dtype(dtype)
        if axis is None:
            out = tfn(x.reshape(-1))
            return out.reshape((1,) * x.ndim if keepdim else ()).to(dt)
        return tfn(x, dim=int(axis), keepdim=keepdim).to(dt)

    return op


argmax = _arg(torch.argmax)
argmin = _arg(torch.argmin)


def argsort(x, axis=-1, descending=False, stable=True, name=None):
    """Stable by default; descending sorts the negated input stably, as
    the reference does (equal keys keep their order)."""
    x = ensure_tensor(x)
    key = -x if descending and x.dtype != torch.bool else x
    idx = torch.argsort(key, dim=int(axis), stable=stable)
    if descending and x.dtype == torch.bool:
        idx = torch.argsort(~x, dim=int(axis), stable=stable)
    return idx


def sort(x, axis=-1, descending=False, stable=True, name=None):
    """Ascending, flipped for ``descending`` (the reference's order)."""
    x = ensure_tensor(x)
    out = torch.sort(x, dim=int(axis), stable=stable).values
    return torch.flip(out, (int(axis),)) if descending else out


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    x = ensure_tensor(x)
    kk = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    vals, idx = torch.topk(x, kk, dim=int(axis), largest=largest,
                           sorted=sorted)
    return vals, idx


def nonzero(x, as_tuple=False):
    """(N, ndim) int64 indices, or a tuple of (N, 1) columns."""
    x = ensure_tensor(x)
    idx = torch.nonzero(x)
    if as_tuple:
        return tuple(idx[:, d:d + 1] for d in range(x.ndim))
    return idx


def index_select(x, index, axis=0, name=None):
    from .manipulation import index_select as _is

    return _is(x, index, axis)


def masked_select(x, mask, name=None):
    from .manipulation import masked_select as _ms

    return _ms(x, mask)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    s = ensure_tensor(sorted_sequence)
    return torch.searchsorted(s, ensure_tensor(values, like=s),
                              out_int32=out_int32, right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The k-th smallest along ``axis`` and its index (the stable sort's
    position, as the reference takes it)."""
    x = ensure_tensor(x)
    ax = int(axis) % x.ndim
    sv, si = torch.sort(x, dim=ax, stable=True)
    vals = sv.select(ax, k - 1)
    idx = si.select(ax, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the index of its first occurrence, as the reference computes them."""
    x = ensure_tensor(x)
    ax = int(axis) % x.ndim
    moved = x.movedim(ax, -1)
    sv = torch.sort(moved, dim=-1).values
    pos = torch.arange(sv.shape[-1], device=x.device).expand(sv.shape)
    starts = torch.ones_like(sv, dtype=torch.bool)
    starts[..., 1:] = sv[..., 1:] != sv[..., :-1]
    # each element's count within its run of equal values; the first
    # position of the largest count ends the smallest most frequent run
    run = pos - torch.cummax(torch.where(starts, pos, 0), dim=-1).values
    best = torch.argmax(run, dim=-1, keepdim=True)
    vals = torch.gather(sv, -1, best)
    first = torch.argmax((moved == vals).to(torch.int8), dim=-1,
                         keepdim=True)
    vals, first = vals.squeeze(-1), first.squeeze(-1)
    if keepdim:
        vals, first = vals.unsqueeze(ax), first.unsqueeze(ax)
    return vals, first


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """``mode`` 'avg' averages the two middles of an even count (numpy's
    median); 'min' takes the lower."""
    x = ensure_tensor(x)
    if mode == "avg":
        if axis is None:
            return _back(torch.quantile(x.reshape(-1).to(_fdt(x)), 0.5), x)
        return _back(torch.quantile(x.to(_fdt(x)), 0.5, dim=axis,
                                    keepdim=keepdim), x)
    if axis is None:
        flat = torch.sort(x.reshape(-1)).values
        return flat[(flat.shape[0] - 1) // 2]
    sv = torch.sort(x, dim=axis).values
    out = sv.select(axis, (x.shape[axis] - 1) // 2)
    return out.unsqueeze(axis) if keepdim else out


def _fdt(x):
    """torch's quantiles take f32 / f64 only: others compute in f32."""
    return x.dtype if x.dtype in (torch.float32, torch.float64) else \
        torch.float32


def _back(out, x):
    return out.to(x.dtype) if x.dtype in (torch.float16,
                                          torch.bfloat16) else out


def nanmedian(x, axis=None, keepdim=False, name=None):
    """numpy's nanmedian: the mean of the two middles of the non-NaN
    values."""
    x = ensure_tensor(x)
    v = x.to(_fdt(x))
    if axis is None:
        return _back(torch.nanquantile(v.reshape(-1), 0.5), x)
    return _back(torch.nanquantile(v, 0.5, dim=axis, keepdim=keepdim), x)


def _quantile(fn):
    def op(x, q, axis=None, keepdim=False, interpolation="linear",
           name=None):
        x = ensure_tensor(x)
        v = x.to(_fdt(x))
        qv = q if isinstance(q, torch.Tensor) else torch.as_tensor(
            q, dtype=v.dtype, device=v.device)
        qv = qv.to(device=v.device, dtype=v.dtype)
        if axis is None:
            return _back(fn(v.reshape(-1), qv, interpolation=interpolation),
                         x)
        if isinstance(axis, (list, tuple)):
            dims = sorted(a % v.ndim for a in axis)
            rest = [d for d in range(v.ndim) if d not in dims]
            flat = v.permute(*rest, *dims).reshape(
                [v.shape[d] for d in rest] + [-1])
            out = fn(flat, qv, dim=-1, interpolation=interpolation)
            if keepdim:
                for d in dims:
                    out = out.unsqueeze(d + (1 if qv.ndim else 0))
            return _back(out, x)
        return _back(fn(v, qv, dim=axis, keepdim=keepdim,
                        interpolation=interpolation), x)

    return op


quantile = _quantile(torch.quantile)
nanquantile = _quantile(torch.nanquantile)
